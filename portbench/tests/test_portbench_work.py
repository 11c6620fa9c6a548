import pytest

from tests import tiny
from pb import work


def test_conv_forward_by_hand():
    ops, nbytes = work.kind("conv")(2, 4, 5, 3, 6, 3, 3)
    assert ops == 2 * 2 * 4 * 5 * 3 * 6 * 9
    assert nbytes == 4 * (2 * 4 * 5 * (3 + 6) + 6 * 3 * 9 + 6)


def test_gamma_counts_the_shared_forward_once_and_one_transpose_a_clone():
    conv = 2 * 4 * 4 * 2 * 3 * 9
    ops, _ = work.kind("gamma")(5, 4, 4, 4, 2, 3)
    assert ops == 5 * conv + 4 * 5 * conv
    ops2, _ = work.kind("gamma")(5, 4, 4, 4, 2, 3, nonneg=False)
    assert ops2 == 2 * 5 * conv + 2 * 4 * 5 * conv


def test_wsquare_epsilon_linear_frontend_by_hand():
    assert work.kind("wsquare")(2, 4, 8, 8, 1, 3)[0] == 2 * 4 * 2 * 8 * 8 * 1 * 3 * 9
    assert work.kind("epsilon")(2, 4, 16, 8, 8)[0] == 2 * 16 * 8 * 8 * 4 * 2
    assert work.kind("epsilon")(2, 4, 16, 8, 8, forward=True)[0] == 2 * 16 * 8 * 8 * (8 + 2)
    assert work.kind("linear")(3, 5, 7) == (2 * 3 * 5 * 7, 4 * (3 * 12 + 35 + 7))
    ops, nbytes = work.kind("frontend")(1, 800, 3, 16, 4, 10)
    assert ops == pytest.approx(3 * (16 + 2.5 * 16 * 4 + 4 * 9 + 20 + 12))
    assert nbytes == 4 * (800 + 3 * 4)


def test_request_work_of_a_tiny_3s_model_by_hand():
    cfg = tiny.config("gtzan3s")
    cfg.update(n_filters=[2, 2, 4, 4, 4], subspace_dim=4, n_dense=8, n_mels=32, mel_width=32)
    b, K = 3, cfg["num_concepts"]
    w = work.request_work(cfg, b)

    def conv(H, ci, co):
        return 2 * H * H * ci * co * 9

    # lower: features.0 wsquare (K clones), 3, 6, 9 gamma on non-negative input, projection
    lower = (K * b * conv(32, 1, 2)
             + (b + K * b) * (conv(16, 2, 2) + conv(8, 2, 4) + conv(4, 4, 4))
             + 2 * 16 * 4 * 4 * (K * b + b))      # n = 4 x 4 positions, d = 4
    assert w["lower"][0] == lower
    # upper: features.12 gamma on input of both signs, one clone; three dense epsilons (4 features past pool 14);
    # the inverse projection's epsilon
    upper = (2 * b + 2 * b) * conv(2, 4, 4) + 2 * b * (4 * 8 + 8 * 8 + 8 * 10) + 2 * 16 * 4 * 4 * b
    assert w["upper"][0] == upper
    assert w["total"][0] == pytest.approx(sum(w[k][0] for k in ("frontend", "forward", "upper", "lower")))


@pytest.mark.parametrize("name,b,teraops", [("gtzan3s", 256, 0.2325), ("gtzan6s", 64, 1.355)])
def test_request_work_of_the_cells(name, b, teraops):
    w = work.request_work(tiny.config(name), b)
    assert w["total"][0] / 1e12 == pytest.approx(teraops, rel=0.01)


def test_least_time_is_the_larger_bound():
    assert work.least_seconds(495e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
