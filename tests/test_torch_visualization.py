"""The port's plotting module against the JAX package's (guide:
tests/test_visualization.py): the heatmap colours bit-equal, the mel-axis
ticks equal, and every plot function drawing under the Agg backend, from
numpy arrays and from tensors."""

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from drsa_audio_tpu.utils import visualization as jviz  # noqa: E402
from drsa_audio_tpu_torch.utils import visualization as tviz  # noqa: E402


@pytest.fixture(autouse=True)
def close_figures():
    yield
    import matplotlib.pyplot as plt
    plt.close("all")


@pytest.mark.parametrize("shape", [(2, 2), (64, 64), (1, 128, 256)])
def test_bwr_heatmap_colors_bit_equal_to_jax(shape):
    hm = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jviz.bwr_heatmap_colors(hm)
    assert np.array_equal(tviz.bwr_heatmap_colors(hm), want)
    assert np.array_equal(tviz.bwr_heatmap_colors(torch.as_tensor(hm)), want)


def test_bwr_colors_of_the_signs():
    rgb = tviz.bwr_heatmap_colors(np.array([[-1.0, 0.0], [0.5, 1.0]]))
    np.testing.assert_allclose(rgb[0, 0], [0, 0, 1], atol=1e-9)     # negative -> blue
    np.testing.assert_allclose(rgb[0, 1], [1, 1, 1], atol=1e-9)     # zero -> white
    np.testing.assert_allclose(rgb[1, 1], [1, 0, 0], atol=1e-9)     # positive -> red


@pytest.mark.parametrize("case", ["gtzan", "gtzan_6s", "toy"])
def test_mel_axis_ticks_equal_jax(case):
    p = tviz.AUDIO_PARAMS[case]
    got = tviz._mel_axis_ticks(p["n_mels"], p["sample_rate"])
    assert got == jviz._mel_axis_ticks(p["n_mels"], p["sample_rate"])
    ax = tviz.plot_spectrogram(np.zeros((p["n_mels"], p["mel_width"])), case=case)
    np.testing.assert_array_equal(ax.get_yticks(), got[0])


def _plots(rng, as_tensor):
    a = (lambda x: torch.as_tensor(x)) if as_tensor else (lambda x: x)
    return {
        "vis_heatmap": lambda m: m.vis_heatmap(a(rng.standard_normal((64, 64))), title="t"),
        "plot_spectrogram": lambda m: m.plot_spectrogram(a(rng.standard_normal((64, 64))),
                                                         case="toy", remove=True),
        "plot_waveform": lambda m: m.plot_waveform(a(rng.standard_normal(16000)), title="w"),
        "plot_aupcs": lambda m: m.plot_aupcs(
            {"a": a(np.array([[1.0]]))}, {"a": a(np.linspace(1, 0, 7))},
            a(np.array([0, 1, 4, 9, 16, 25, 9]))),
        "plot_train_stats": lambda m: m.plot_train_stats(
            {"train_loss": [1, 0.5], "valid_losses": [1.1, 0.6], "train_acc": [0.5, 0.8],
             "valid_acc": [0.4, 0.7]}),
        "plot_drsa_objective": lambda m: m.plot_drsa_objective(a(rng.random((3, 50)))),
        "make_drsa_subplot": lambda m: m.make_drsa_subplot(
            a(rng.standard_normal((64, 64))), a(rng.standard_normal((64, 64))),
            [a(rng.standard_normal((64, 64))) for _ in range(2)], case="toy", suptitle="s"),
    }


@pytest.mark.parametrize("name", ["vis_heatmap", "plot_spectrogram", "plot_waveform",
                                  "plot_aupcs", "plot_train_stats", "plot_drsa_objective",
                                  "make_drsa_subplot"])
def test_plot_functions_draw_under_agg(name):
    """Each draws from numpy arrays and from tensors what the JAX package's
    draws from the arrays: the same artists' data."""
    import matplotlib.pyplot as plt
    figs = []
    for module, as_tensor in ((jviz, False), (tviz, False), (tviz, True)):
        out = _plots(np.random.default_rng(1), as_tensor)[name](module)
        fig = out if hasattr(out, "savefig") else np.ravel(out)[0].figure
        fig.canvas.draw()
        figs.append([(type(art).__name__, np.asarray(art.get_array()).tolist()
                      if hasattr(art, "get_array") and art.get_array() is not None
                      else np.asarray(art.get_xydata()).tolist())
                     for ax in fig.axes for art in ax.get_images() + ax.get_lines()])
        plt.close(fig)
    assert figs[1] == figs[0] and figs[2] == figs[0]
    assert figs[0]
