"""The nowcasts of the PyTorch port beside STEPS (extrapolation, eulerian,
lagrangian, lagrangian_probability, S-PROG, ANVIL) through
``nowcasts.get_method(name)``, against the JAX package's on the CPU at
128^2 with 3 leads, on inputs from a numpy seed.

Tolerances, with identical NaN sets everywhere:
- extrapolation, eulerian, lagrangian: 1e-5 x span (one exact warp);
- lagrangian_probability: 1e-4 (probabilities; float32 FFT convolution);
- S-PROG: 1e-3 x span.  Its CDF match sorts packed, quantized values, so
  a rounding difference can swap two pixels of tied rank and move each to
  the neighbouring target quantile (the STEPS scans' tolerance);
- ANVIL: the loop started from the JAX package's init state within 1e-4
  x span.  The whole forecast within 1e-3 x span and 1e-6 x span on
  average: its lag-2 parameters, (g1 - g0^2) / (1 - g0^2), cancel where
  a level's lag-1 correlation g0 nears 1, so float32 rounding of the
  Gaussian window sums moves a few pixels by up to 2e-4 x span.
"""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu import cascade as jcascade  # noqa: E402
from pysteps_tpu import nowcasts as jnowcasts  # noqa: E402
from pysteps_tpu.nowcasts import anvil as janvil  # noqa: E402
from pysteps_tpu.nowcasts import sprog as jsprog  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402
from pysteps_tpu_torch.nowcasts import anvil as tanvil  # noqa: E402
from pysteps_tpu_torch.nowcasts import sprog as tsprog  # noqa: E402
from pysteps_tpu_torch.nowcasts.steps import tree_from_numpy  # noqa: E402

SIDE = 128


@pytest.fixture(scope="module")
def inputs():
    """Four rain-rate frames with dry areas (made at 256^2, subsampled),
    their dB values, and a non-integer motion of (1.7, 0.6) px a step,
    so no sampling position sits on the domain edge."""
    frames = make_synthetic_sequence(
        n_frames=4, shape=(2 * SIDE, 2 * SIDE), velocity=(3.4, 1.2), seed=42,
    )[:, ::2, ::2].astype(np.float32)
    db = np.where(frames >= 0.1, 10.0 * np.log10(np.maximum(frames, 0.1)), -15.0)
    db = db.astype(np.float32)
    vel = np.zeros((2, SIDE, SIDE), np.float32)
    vel[0], vel[1] = 1.7, 0.6
    return frames, db, vel


def _close(ref, out, rel, of_span=True, mean_rel=None):
    ref = np.asarray(ref, np.float64)
    out = (out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)).astype(np.float64)
    assert ref.shape == out.shape
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    scale = float(np.nanmax(ref) - np.nanmin(ref)) if of_span else 1.0
    diff = np.abs(np.nan_to_num(ref) - np.nan_to_num(out))
    assert diff.max() <= rel * scale, (diff.max(), scale)
    if mean_rel is not None:
        assert diff.mean() <= mean_rel * scale, (diff.mean(), scale)


def test_registry_matches_jax_but_linda():
    """The two registries are equal, ``linda`` included (the name is kept
    from before the port had it): the same names in the same order, each
    with JAX's signature plus ``device``, the same errors."""
    j_names = list(jnowcasts.interface._nowcast_methods)
    t_names = list(tnowcasts.interface._nowcast_methods)
    assert t_names == j_names and "linda" in t_names
    for name in t_names:
        j_params = list(inspect.signature(jnowcasts.get_method(name)).parameters)
        t_params = list(inspect.signature(tnowcasts.get_method(name)).parameters)
        expected = j_params if name == "eulerian" else j_params + ["device"]
        assert t_params == expected, name
    for package, names in ((jnowcasts, j_names), (tnowcasts, t_names)):
        with pytest.raises(ValueError) as err:
            package.get_method("lindax")
        assert str(err.value) == f"unknown nowcasting method lindax; available: {names}"
        with pytest.raises(ValueError, match="name is None"):
            package.get_method(None)
    assert tnowcasts.get_method("SPROG") is tsprog.forecast
    assert tnowcasts.get_method("LINDA") is tnowcasts.linda.forecast


@pytest.mark.parametrize("name", ["extrapolation", "lagrangian", "eulerian"])
@pytest.mark.parametrize("timesteps", [3, [0.5, 2.0]])
def test_extrapolation_nowcasts(inputs, name, timesteps):
    _, db, vel = inputs
    ref = jnowcasts.get_method(name)(db[-1], vel, timesteps)
    out = tnowcasts.get_method(name)(db[-1], vel, timesteps, device="cpu")
    assert out.device.type == "cpu"
    _close(ref, out, 1e-5)


def test_extrapolation_nowcast_measure_time_and_errors(inputs):
    _, db, vel = inputs
    f = tnowcasts.get_method("extrapolation")
    out, init_s, loop_s = f(db[-1], vel, 2, measure_time=True, device="cpu")
    assert out.shape == (2, SIDE, SIDE) and init_s == 0.0 and loop_s >= 0.0
    with pytest.raises(ValueError, match="two-dimensional"):
        f(db, vel, 2, device="cpu")


@pytest.mark.parametrize("timesteps", [3, [1, 2.5]])
def test_lagrangian_probability(inputs, timesteps):
    frames, _, vel = inputs
    ref = jnowcasts.get_method("probability")(frames[-1], vel, timesteps, 1.0, slope=2)
    out = tnowcasts.get_method("lagrangian_probability")(
        frames[-1], vel, timesteps, 1.0, slope=2, device="cpu")
    _close(ref, out, 1e-4, of_span=False)
    assert float(np.nanmax(out.numpy())) <= 1.0 and float(np.nanmin(out.numpy())) >= 0.0


SPROG = {
    "int": (3, {}),
    "fractional": ([0.5, 1.5, 2.25, 3], {}),
    "mean-conditional": (2, dict(probmatching_method="mean", conditional=True)),
}


@pytest.mark.parametrize("case", sorted(SPROG))
def test_sprog_forecast(inputs, case):
    _, db, vel = inputs
    timesteps, extra = SPROG[case]
    kw = dict(n_cascade_levels=6, precip_thr=-10.0, **extra)
    ref = jnowcasts.get_method("sprog")(db[-3:], vel, timesteps, **kw)
    out = tnowcasts.get_method("sprog")(db[-3:], vel, timesteps, device="cpu", **kw)
    assert out.device.type == "cpu"
    _close(ref, out, 1e-3)


@pytest.fixture(scope="module")
def sprog_init(inputs):
    _, db, vel = inputs
    w = np.asarray(jcascade.get_method("gaussian")((SIDE, SIDE), 6)["weights_2d"], np.float32)
    args = dict(ar_order=2, conditional=False, n_iter=1, interp_order=1)
    ref = jsprog._sprog_init(jnp.asarray(db[-3:]), jnp.asarray(vel), jnp.asarray(w),
                             jnp.float32(-10.0), **args)
    out = tsprog._sprog_init(torch.tensor(db[-3:]), torch.tensor(vel), torch.tensor(w),
                             -10.0, **args)
    return [np.asarray(x) for x in ref], out


def test_sprog_init_matches_jax(sprog_init):
    """Every init output within 1e-4 x its largest magnitude, as the STEPS
    init's parameters are held (the Yule-Walker solve amplifies rounding
    where a lag-1 correlation nears 1)."""
    ref, out = sprog_init
    names = ("rain_frac", "window0", "means", "stds", "gamma", "phi", "precip_last",
             "precip_min", "war", "mu_0", "domain_mask")
    for name, r, o in zip(names, ref, out):
        o = o.numpy()
        assert o.shape == r.shape, name
        scale = max(float(np.max(np.abs(r))), 1e-6) if r.dtype != bool else 1.0
        assert np.max(np.abs(o.astype(np.float64) - r), initial=0.0) <= 1e-4 * scale, name


def test_sprog_scan_from_jax_init(inputs, sprog_init):
    """The loop started from the JAX init (``tree_from_numpy``), both with
    the sort matcher."""
    _, _, vel = inputs
    ref_init, _ = sprog_init
    (_, window0, means, stds, _, phi, precip_last, precip_min, war, mu_0,
     domain_mask) = ref_init
    ref = jsprog._sprog_scan(
        jnp.asarray(window0), jnp.asarray(vel), jnp.asarray(phi), jnp.asarray(means[-1]),
        jnp.asarray(stds[-1]), jnp.asarray(precip_last), jnp.asarray(precip_min),
        jnp.float32(-10.0), jnp.asarray(war), jnp.asarray(mu_0), jnp.asarray(domain_mask),
        3, "cdf", 1, 1)
    t = tree_from_numpy(ref_init, "cpu")
    out = tsprog._sprog_scan(t[1], torch.tensor(vel), t[5], t[2][-1], t[3][-1], t[6], t[7],
                             -10.0, t[8], t[9], t[10], 3, "cdf", 1, 1)
    _close(ref, out, 1e-3)


def test_sprog_no_rain_exit(inputs, capsys):
    _, db, vel = inputs
    dry = np.full_like(db[-3:], -15.0)
    kw = dict(n_cascade_levels=6, precip_thr=-10.0)
    ref = jnowcasts.get_method("sprog")(dry, vel, 2, **kw)
    out = tnowcasts.get_method("sprog")(dry, vel, 2, device="cpu", **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert "No precipitation above the threshold" in capsys.readouterr().out


ANVIL = {
    "ar2": (3, {}),
    "ar1-fractional": ([0.5, 2.0], dict(ar_order=1)),
    "rainrate": (2, {}),
}


@pytest.mark.parametrize("case", sorted(ANVIL))
def test_anvil_forecast(inputs, case):
    frames, _, vel = inputs
    timesteps, extra = ANVIL[case]
    vil = frames[-(extra.get("ar_order", 2) + 2):]
    if case == "rainrate":
        extra = dict(rainrate=frames[-1] * 0.5)
    kw = dict(n_cascade_levels=6, **extra)
    ref = jnowcasts.get_method("anvil")(vil, vel, timesteps, **kw)
    out = tnowcasts.get_method("anvil")(vil, vel, timesteps, device="cpu", **kw)
    _close(ref, out, 1e-3, mean_rel=1e-6)


@pytest.fixture(scope="module")
def anvil_init(inputs):
    frames, _, vel = inputs
    w = np.asarray(jcascade.get_method("gaussian")((SIDE, SIDE), 6)["weights_2d"], np.float32)
    finite = np.all(np.isfinite(frames), axis=0)
    ref = janvil._anvil_init(jnp.asarray(frames), jnp.asarray(vel), jnp.asarray(w),
                             jnp.asarray(finite), 2, 50, 1, 1)
    out = tanvil._anvil_init(torch.tensor(frames), torch.tensor(vel), torch.tensor(w),
                             torch.tensor(finite), 2, 50, 1, 1)
    return [np.asarray(x) for x in ref], out


def test_anvil_init_matches_jax(anvil_init):
    """The cascade window within 1e-5 x its size and the masks equal.  The
    per-pixel parameters amplify float32 rounding by up to 1 / (1 - g0^2)
    where a lag-1 correlation g0 nears 1 (the largest scale, everywhere):
    their median within 1e-5, 99% of the pixels within 1e-3.  The
    functions that make them are held one by one below."""
    (window, phi, mask, rr_mask), out = anvil_init
    _close(window, out[0], 1e-5, of_span=False)
    np.testing.assert_array_equal(out[2].numpy(), mask)
    np.testing.assert_array_equal(out[3].numpy(), rr_mask)
    assert out[1].shape == phi.shape
    err = np.abs(out[1].numpy() - phi).max(axis=1)
    assert np.median(err) <= 1e-5 and np.percentile(err, 99) <= 1e-3, (
        np.median(err), np.percentile(err, 99))


@pytest.mark.parametrize("ar_order", [1, 2])
def test_anvil_filter_and_parameter_maps(ar_order):
    """The Gaussian filter (401 taps on 40 x 48 fields, wider than the
    field) within 1e-6 x its largest value, the ARI parameter maps from
    the same correlations within 1e-6 x theirs, and one ARI step within
    1e-6 x the window's size."""
    rng = np.random.default_rng(5)
    fields = rng.normal(size=(3, 40, 48)).astype(np.float32)
    for radius in (3, 50):
        ref = janvil._gauss_filter_batch(jnp.asarray(fields), janvil._gaussian_kernel1d(radius))
        out = tanvil._gauss_filter_batch(torch.tensor(fields), tanvil._gaussian_kernel1d(radius))
        _close(ref, out, 1e-6 * float(np.max(np.abs(np.asarray(ref)))), of_span=False)
    gamma = rng.uniform(-0.95, 0.95, (ar_order, 40, 48)).astype(np.float32)
    f_j = janvil._estimate_ar2_params if ar_order == 2 else janvil._estimate_ar1_params
    f_t = tanvil._estimate_ar2_params if ar_order == 2 else tanvil._estimate_ar1_params
    ref = np.asarray(f_j(jnp.asarray(gamma)))
    _close(ref, f_t(torch.tensor(gamma)), 1e-6 * float(np.max(np.abs(ref))), of_span=False)
    window = rng.normal(size=(2, ar_order + 1, 40, 48)).astype(np.float32)
    phi = np.stack([ref, ref[::-1]]).astype(np.float32)
    ref_w = janvil._iterate_ari_localized(jnp.asarray(window), jnp.asarray(phi))
    out_w = tanvil._iterate_ari_localized(torch.tensor(window), torch.tensor(phi))
    _close(ref_w, out_w, 1e-6 * float(np.max(np.abs(np.asarray(ref_w)))), of_span=False)


def test_anvil_scan_from_jax_init(inputs, anvil_init):
    frames, _, vel = inputs
    (window, phi, mask, rr_mask), _ = anvil_init
    m = n = SIDE
    zeros = np.zeros((m, n), np.float32)
    dom = ~np.isfinite(frames[-1])
    ref = janvil._anvil_scan(
        jnp.asarray(window), jnp.asarray(vel), jnp.asarray(phi), jnp.asarray(mask),
        jnp.asarray(rr_mask), jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(dom),
        3, False, True, 1, 1)
    t = tree_from_numpy((window, phi, mask, rr_mask, zeros, dom), "cpu")
    out = tanvil._anvil_scan(t[0], torch.tensor(vel), t[1], t[2], t[3], t[4], t[4], t[5],
                             3, False, True, 1, 1)
    _close(ref, out, 1e-4)


@pytest.mark.parametrize("radius", [None, 3])
def test_anvil_moving_window_corrcoef_and_regression(radius):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 48)).astype(np.float32)
    y = (0.6 * x + 0.8 * rng.normal(size=(40, 48))).astype(np.float32)
    mask = rng.random((40, 48)) > 0.1
    ref = janvil._moving_window_corrcoef(jnp.asarray(x), jnp.asarray(y), radius,
                                         jnp.asarray(mask))
    out = tanvil._moving_window_corrcoef(torch.tensor(x), torch.tensor(y), radius,
                                         torch.tensor(mask))
    _close(ref, out, 1e-5, of_span=False)
    vil = np.abs(rng.normal(15.0, 8.0, (40, 48))).astype(np.float32)
    r = (0.3 * vil + rng.normal(0.0, 1.0, (40, 48))).astype(np.float32)
    ref_ab = janvil._r_vil_regression(jnp.asarray(vil), jnp.asarray(r), radius or 5)
    out_ab = tanvil._r_vil_regression(torch.tensor(vil), torch.tensor(r), radius or 5)
    for a, b in zip(ref_ab, out_ab):
        _close(a, b, 1e-4, of_span=False)
