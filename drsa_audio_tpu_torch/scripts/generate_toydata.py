"""Generate the synthetic toy dataset with the port (reference notebook
dataprep/toydata/generate_toydata.ipynb as a deterministic CLI):

    python -m drsa_audio_tpu_torch.scripts.generate_toydata --out DIR

The flags of the JAX package's scripts/generate_toydata.py, plus
``--device``. The clips are drawn with numpy (data/toydata.py), so the same
seed writes the same WAV bytes and split lists as the JAX script; the
device is resolved as every CLI of the port resolves it (CUDA unless
named, raising without a card), and no work runs there.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--per-class", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    from drsa_audio_tpu_torch.data.toydata import generate_dataset
    from drsa_audio_tpu_torch.utils.device import resolve_device

    resolve_device(args.device, "generate_toydata")
    splits = generate_dataset(args.out, args.per_class, args.seed, args.noise)
    for k, v in splits.items():
        print(f"{k}: {len(v)} samples")


if __name__ == "__main__":
    main()
