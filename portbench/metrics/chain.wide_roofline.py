"""The wide chain convs' least time over ``chain.wide_ms``, %: the least
time is the larger of their operations at 495 TFLOP/s (dense TF32) and
their bytes at 3.35 TB/s, counted from the shapes by ``work/gamma.py`` as
``lower_roofline`` counts the lower segment: the gamma rule, K clones, of
every conv of the lower segment over 128 channels, at the window's clips a
request. None where ``chain.wide_ms`` reads nothing."""

import run as harness
from pb.model import layer_plan
from pb.work import kind, least_seconds


def wide_work(cfg: dict, b: int) -> tuple[float, float]:
    """(operations, bytes) of the gamma rule of the lower segment's convs
    over 128 channels, for a request of ``b`` clips."""
    rules = {n: r for n, r, _ in cfg["rules"]}
    ops = nbytes = 0.0
    for ly in layer_plan(cfg):
        if ly["name"] == f"features.{cfg['drsa_layer']}":
            break
        if (ly["kind"] == "conv" and rules.get(ly["name"]) == "gamma"
                and max(ly["in_ch"], ly["out_ch"]) > 128):
            o, w = kind("gamma")(b, cfg["num_concepts"], *ly["hw"], ly["in_ch"], ly["out_ch"],
                                 *ly["kernel"])
            ops, nbytes = ops + o, nbytes + w
    return ops, nbytes


def read(run):
    ms = harness.load("metrics", "chain.wide_ms").read(run)
    if ms is None:
        return None
    b = int(round(run.clips_per_request or run.traffic["batch"]))
    return 100.0 * least_seconds(*wide_work(run.cfg, b)) / (ms * 1e-3)
