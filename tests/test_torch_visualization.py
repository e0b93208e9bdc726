"""The port's ``visualization`` on the Agg backend: every test of
``tests/test_visualization.py`` run against ``pysteps_tpu_torch`` with the
same parametrisations, then the artists that each plot draws (image array,
colormap, norm bounds, axis limits, quiver U/V, lines) held equal to those
of the JAX package's plot on the same input, and the plots given CPU
tensors instead of numpy."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _close_figs():
    # close both before and after: earlier test FILES (e.g. verification
    # plot tests) may leave figures open, and plot_precip_field draws onto
    # plt.gca() like the reference does
    plt.close("all")
    yield
    plt.close("all")


def _field(m=32, n=48, seed=0):
    rng = np.random.RandomState(seed)
    f = rng.exponential(2.0, (m, n))
    f[f < 1.0] = 0.0
    f[0, 0] = np.nan
    return f


GEODATA = {
    "x1": 0.0, "x2": 48000.0, "y1": 0.0, "y2": 32000.0,
    "yorigin": "upper", "projection": None, "unit": "mm/h",
}


@pytest.mark.parametrize(
    "ptype,units",
    [("intensity", "mm/h"), ("intensity", "dBZ"), ("depth", "mm"), ("prob", "mm/h")],
)
def test_plot_precip_field(ptype, units):
    from pysteps_tpu_torch.visualization import plot_precip_field

    f = _field()
    if ptype == "prob":
        f = np.clip(f / 10.0, 0, 1)
    ax = plot_precip_field(f, ptype=ptype, units=units, title="t",
                           geodata=GEODATA)
    assert ax is not None
    assert len(ax.get_images()) == 1


def test_plot_precip_field_colormap_config_and_bbox():
    from pysteps_tpu_torch.visualization import plot_precip_field
    from pysteps_tpu_torch.visualization.precipfields import get_colormap

    cmap, norm, clevs, _ = get_colormap("intensity", "mm/h", "pysteps")

    class Cfg:
        pass

    cfg = Cfg()
    cfg.cmap, cfg.norm, cfg.clevs = cmap, norm, clevs
    ax = plot_precip_field(_field(), colormap_config=cfg,
                           bbox=(2, 2, 20, 20), axis="off", colorbar=False)
    assert ax.get_xlim() == (2.0, 20.0)

    bad = Cfg()
    with pytest.raises(ValueError, match="missing attributes"):
        plot_precip_field(_field(), colormap_config=bad)


@pytest.mark.parametrize("plot_type", ["quiver", "streamplot"])
@pytest.mark.parametrize("with_geodata", [False, True])
def test_motion_plot(plot_type, with_geodata):
    from pysteps_tpu_torch.visualization import motion_plot

    uv = np.ones((2, 32, 48), np.float32)
    uv[1] *= -0.5
    ax = motion_plot(uv, plot_type=plot_type, step=8,
                     geodata=GEODATA if with_geodata else None)
    assert ax is not None


def test_motion_plot_invalid_type():
    from pysteps_tpu_torch.visualization import motion_plot

    with pytest.raises(ValueError, match="unknown plot_type"):
        motion_plot(np.ones((2, 8, 8)), plot_type="arrows")


def test_animate_saves_frames(tmp_path):
    from pysteps_tpu_torch.visualization import animate

    obs = np.stack([_field(seed=i) for i in range(2)])
    fct = np.stack([np.stack([_field(seed=10 + i) for i in range(3)])
                    for _ in range(2)])  # (E, T, m, n)
    animate(obs, precip_fct=fct, motion_field=np.ones((2, 32, 48)),
            display_animation=False, savefig=True, fig_dpi=30,
            path_outputs=str(tmp_path))
    pngs = sorted(p.name for p in tmp_path.glob("*.png"))
    assert len(pngs) == 5  # 2 obs + 3 forecast frames


def test_plot_spectrum1d():
    from pysteps_tpu_torch.visualization import plot_spectrum1d

    freq = np.fft.fftfreq(64)[: 32]
    power = np.abs(np.fft.fft(np.random.RandomState(0).randn(64)))[:32] ** 2
    ax = plot_spectrum1d(freq, power, x_units="km", y_units="dBR",
                         wavelength_ticks=[2, 4, 8, 16], label="psd")
    assert ax.get_legend() is not None


def test_thunderstorm_track_plots():
    import pandas as pd

    from pysteps_tpu_torch.visualization.thunderstorms import (
        plot_cart_contour,
        plot_track,
    )

    tracks = [pd.DataFrame({"cen_x": [1.0, 2.0], "cen_y": [3.0, 4.0]})]
    ax = plot_track(tracks, ref_shape=(32, 48))
    assert ax.get_xlim() == (0.0, 48.0)
    contours = [[np.array([[1, 2], [3, 4]])], np.array([[5, 6]]).reshape(1, 2)]
    ax = plot_cart_contour(contours, ref_shape=(32, 48))
    assert ax is not None


def test_verification_plots():
    from pysteps_tpu_torch.verification import plots as vplots
    from pysteps_tpu_torch.verification.ensscores import rankhist_init, rankhist_accum
    from pysteps_tpu_torch.verification.probscores import (
        reldiag_init,
        reldiag_accum,
        ROC_curve_init,
        ROC_curve_accum,
    )

    rng = np.random.RandomState(1)
    obs = rng.exponential(1.0, (24, 24))
    ens = obs[None] + 0.4 * rng.randn(5, 24, 24)

    rh = rankhist_init(5, X_min=0.1)
    rankhist_accum(rh, ens, obs, device="cpu")
    fig, ax = plt.subplots()
    vplots.plot_rankhist(rh, ax=ax)  # state-dict form (reference contract)

    from pysteps_tpu_torch.verification.spatialscores import (
        intensity_scale_accum,
        intensity_scale_init,
    )

    iss = intensity_scale_init("FSS", [0.5, 1.0], [2, 4])
    intensity_scale_accum(iss, ens[0], obs, device="cpu")
    vplots.plot_intensityscale(iss, kmperpixel=2.0, unit="mm/h")

    prob = (ens >= 1.0).mean(axis=0)
    rd = reldiag_init(1.0)
    reldiag_accum(rd, prob, obs, device="cpu")
    fig, ax = plt.subplots()
    vplots.plot_reldiag(rd, ax=ax)

    roc = ROC_curve_init(1.0)
    ROC_curve_accum(roc, prob, obs, device="cpu")
    fig, ax = plt.subplots()
    vplots.plot_ROC(roc, ax=ax, opt_prob_thr=True)


# ---------------------------------------------------------------------------
# the port's artists against the JAX package's on the same inputs


def _both(module, name):
    """(port's function, JAX's function) of ``visualization.<module>``."""
    import importlib

    return tuple(getattr(importlib.import_module(f"{pkg}.visualization.{module}"), name)
                 for pkg in ("pysteps_tpu_torch", "pysteps_tpu"))


def _norm_state(norm):
    state = {"type": type(norm).__name__, "vmin": norm.vmin, "vmax": norm.vmax}
    if hasattr(norm, "boundaries"):
        state["boundaries"] = np.asarray(norm.boundaries)
    return state


def _axes_state(ax):
    """What an axis shows: its images (masked array, colormap, norm),
    quivers (U, V, offsets), lines, stream lines and limits."""
    from matplotlib.collections import LineCollection
    from matplotlib.quiver import Quiver

    images = []
    for im in ax.get_images():
        arr = im.get_array()
        cmap = im.get_cmap()
        images.append({
            "data": np.ma.filled(arr.astype(float), np.nan),
            "mask": np.ma.getmaskarray(arr),
            "cmap": (cmap.name, cmap.N, cmap(np.linspace(0, 1, cmap.N))),
            "norm": _norm_state(im.norm),
            "extent": im.get_extent(),
        })
    quivers = [{"U": np.asarray(q.U), "V": np.asarray(q.V), "XY": np.asarray(q.XY)}
               for q in ax.collections if isinstance(q, Quiver)]
    streams = [np.concatenate([np.asarray(s) for s in c.get_segments()])
               for c in ax.collections if isinstance(c, LineCollection)]
    lines = [np.asarray(ln.get_xydata()) for ln in ax.get_lines()]
    return {"images": images, "quivers": quivers, "streams": streams, "lines": lines,
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim(), "title": ax.get_title(),
            "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel()}


def _draw(fn, *args, **kwargs):
    fig, ax = plt.subplots()
    fn(*args, ax=ax, **kwargs)
    state = _axes_state(ax)
    plt.close(fig)
    return state


@pytest.mark.parametrize(
    "ptype,units",
    [("intensity", "mm/h"), ("intensity", "dBZ"), ("depth", "mm"), ("prob", "mm/h")],
)
@pytest.mark.parametrize("geodata", [None, GEODATA])
def test_precip_field_artists_match_jax(ptype, units, geodata):
    port, jax_fn = _both("precipfields", "plot_precip_field")
    f = _field()
    if ptype == "prob":
        f = np.clip(f / 10.0, 0, 1)
    a = _draw(port, f, ptype=ptype, units=units, geodata=geodata, title="t")
    b = _draw(jax_fn, f, ptype=ptype, units=units, geodata=geodata, title="t")
    assert len(a["images"]) == 1
    np.testing.assert_equal(a, b)


@pytest.mark.parametrize("plot_type", ["quiver", "streamplot"])
@pytest.mark.parametrize("with_geodata", [False, True])
def test_motion_plot_artists_match_jax(plot_type, with_geodata):
    port, jax_fn = _both("motionfields", "motion_plot")
    rng = np.random.RandomState(4)
    uv = (1.0 + 0.3 * rng.randn(2, 32, 48)).astype(np.float32)
    geo = GEODATA if with_geodata else None
    a = _draw(port, uv, plot_type=plot_type, step=8, geodata=geo)
    b = _draw(jax_fn, uv, plot_type=plot_type, step=8, geodata=geo)
    assert len(a["quivers"] if plot_type == "quiver" else a["streams"]) == 1
    np.testing.assert_equal(a, b)


def test_spectrum_and_track_artists_match_jax():
    import pandas as pd

    freq = np.fft.fftfreq(64)[:32]
    power = np.abs(np.fft.fft(np.random.RandomState(0).randn(64)))[:32] ** 2
    port, jax_fn = _both("spectral", "plot_spectrum1d")
    kw = dict(x_units="km", y_units="dBR", wavelength_ticks=[2, 4, 8, 16], label="psd")
    a, b = _draw(port, freq, power, **kw), _draw(jax_fn, freq, power, **kw)
    assert len(a["lines"]) == 1
    np.testing.assert_equal(a, b)

    tracks = [pd.DataFrame({"cen_x": [1.0, 2.0, 4.0], "cen_y": [3.0, 4.0, 4.5]})]
    port, jax_fn = _both("thunderstorms", "plot_track")
    np.testing.assert_equal(_draw(port, tracks, ref_shape=(32, 48)),
                            _draw(jax_fn, tracks, ref_shape=(32, 48)))
    contours = [[np.array([[1, 2], [3, 4]])], np.array([[5, 6]]).reshape(1, 2)]
    port, jax_fn = _both("thunderstorms", "plot_cart_contour")
    a = _draw(port, contours, ref_shape=(32, 48))
    assert len(a["lines"]) == 2
    np.testing.assert_equal(a, _draw(jax_fn, contours, ref_shape=(32, 48)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plots_take_tensors(tmp_path, dtype):
    """CPU tensors draw what the numpy arrays they read back to draw; the
    contours of the track plot and the animation's fields too."""
    import torch

    from pysteps_tpu_torch.visualization import (
        animate,
        motion_plot,
        plot_precip_field,
        plot_spectrum1d,
    )
    from pysteps_tpu_torch.visualization.thunderstorms import plot_cart_contour

    tdt = getattr(torch, dtype)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(tdt)

    def host(x):
        return tensor(x).float().numpy()

    f = _field()
    np.testing.assert_equal(_draw(plot_precip_field, tensor(f), geodata=GEODATA),
                            _draw(plot_precip_field, host(f), geodata=GEODATA))
    uv = np.stack([np.full((32, 48), 1.25), np.full((32, 48), -0.5)])
    for kind in ("quiver", "streamplot"):
        np.testing.assert_equal(_draw(motion_plot, tensor(uv), plot_type=kind, step=8),
                                _draw(motion_plot, host(uv), plot_type=kind, step=8))
    freq = np.fft.fftfreq(64)[1:32]
    power = 1.0 / freq**2
    np.testing.assert_equal(_draw(plot_spectrum1d, tensor(freq), tensor(power)),
                            _draw(plot_spectrum1d, host(freq), host(power)))
    contours = [[tensor([[1, 2], [3, 4]])]]
    np.testing.assert_equal(_draw(plot_cart_contour, contours, ref_shape=(32, 48)),
                            _draw(plot_cart_contour, [[host([[1, 2], [3, 4]])]],
                                  ref_shape=(32, 48)))
    obs = np.stack([_field(seed=i) for i in range(2)])
    animate(tensor(obs), precip_fct=tensor(obs[None]), motion_field=tensor(uv),
            display_animation=False, savefig=True, fig_dpi=30, path_outputs=str(tmp_path))
    assert len(list(tmp_path.glob("*.png"))) == 4
