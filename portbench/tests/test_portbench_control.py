"""The control on the card, at the cells' widths and a few clips: the plain
reference computed with TF32 on (the next precision below the
configurations' float32) in the program's place is not correct under the
cell's limits, nor is the program with TF32 on or with a fault planted,
and the sound program is. Run on the card with
``python -m pytest --noconftest -p no:cacheprovider -m gpu portbench/tests -q``;
on the full cells, ``python3 portbench/control.py`` reads the same numbers
at the cells' own sizes."""

import pytest

from tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 runs on the card only")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell,batch", [("gtzan3s.serve_b256", 16), ("gtzan6s.serve_b64", 8)])
def test_the_control_is_not_correct_and_the_program_is(cell, batch, card):
    import control
    from pb import check
    c = tiny.run.resolve(tiny.run.read_json(tiny.REPO / "BENCHMARK.json"), cell)
    c["traffic"].update(batch=batch, pool=1, warm_requests=1)
    rows = {r["side"]: r for r in control.readings(c, 2 ** 31 + 29, True, device=card)}
    assert check.judge(rows["program"], c["limits"])[0], rows["program"]
    for side, row in rows.items():
        if side != "program":
            assert not check.judge(row, c["limits"])[0], row
