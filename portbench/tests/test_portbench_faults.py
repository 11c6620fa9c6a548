"""A whole run on the CPU at a tiny width, with the cell's own limits: sound,
it is correct; with the timed path broken underneath, it is not. The
faults a serving cell can have (``pb.faults``): half of the batch left out
(the other half's results in its place), a tenth of the clips' maps gone
wrong with every sum kept, an answer altered where it is produced (one
clip's logits), a sort that does not sort, concept maps out of step with
their relevances and order, relevances zeroed, and another class's
projections. (A state left unchanged and an exchange between chips left
out do not arise: the service keeps no state across requests, and every
cell runs on one chip.) The harness's look for a card is skipped:
``run_cell`` runs on the CPU."""

import time

import pytest

from tests import tiny
from pb import faults

CELL = "gtzan3s.serve_b256"


def _run(monkeypatch=None, fault=None, batch=8):
    from drsa_audio_tpu_torch.serving import ExplainerService
    if fault is not None:
        real = ExplainerService._finalize

        def broken(self, out):
            return fault(real(self, out))
        monkeypatch.setattr(ExplainerService, "_finalize", broken)
    c = tiny.cell(CELL, batch=batch)
    return tiny.run.run_cell(c, 2 ** 31 + 17, 1.0, False, device="cpu",
                             t_start=time.perf_counter(), info=lambda d: None)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) >= {"clips_per_s", "setup_s"}


@pytest.mark.parametrize("fault", faults.RESULT_FAULTS, ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    res = _run(monkeypatch, fault)
    assert not res["correct"], res["checks"]


def test_another_classes_projections_are_not_correct(monkeypatch):
    from pb import program
    real = program.service
    monkeypatch.setattr(program, "service",
                        lambda cfg, p, U, d: real(cfg, p, faults.wrong_projections(U), d))
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["sub_p50"]["value"] > res["checks"]["sub_p50"]["limit"]


def test_judge_fails_a_missing_number_unless_its_capture_point_is_gone():
    from pb import check
    limits = {"logits": 1e-4, "logmel_rms": 1e-5}
    assert check.judge({"logits": 1e-6, "logmel_rms": 1e-7}, limits)[0]
    assert not check.judge({"logits": 1e-6}, limits)[0]
    ok, table = check.judge({"logits": 1e-6}, limits, captured=False)
    assert ok and table["logmel_rms"]["value"] is None
    assert not check.judge({"logmel_rms": 1e-7}, limits, captured=False)[0]
    assert not check.judge({"logits": 1e-3, "logmel_rms": 1e-7}, limits)[0]
