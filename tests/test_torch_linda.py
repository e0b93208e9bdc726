"""LINDA in the PyTorch port against the JAX package on the CPU, part by
part and as a whole, on the same seeded inputs (rain rate with dry areas,
a non-integer motion of (1.7, 0.6) px a step; 64^2 with at most 4
features unless stated).

Tolerances:
- window weights equal; kernel spectra of given parameters, the FFT
  convolutions, the ARI fits and the perturbation fields of one white
  spectrum within 1e-5 of their scale; the Adam update bit-equal to
  optax's; the fit's objective and its gradient at an anisotropic point
  within 1e-5 and 1e-3 relative;
- the fitted kernels: held on their objective.  The kernel is isotropic
  at the fit's start, so its first gradient in phi is 0 but for FFT
  rounding and Adam turns that sign into a full step of 0.1: the two
  packages' fits part there and may settle on other optima of about the
  same objective (one blob feature's reaches 1590.8 in JAX's jitted init,
  1615.5 in JAX's ``_fit_kernels`` alone and 1598.2 in the port); each
  fit's objective within 1% of JAX's, kernel 1's on JAX's aligned
  differences, kernel 2's on kernel 1 of JAX's init;
- the rest of the init on JAX's fitted spectra handed over: the mask
  normalizers within 5e-3 of their largest value, psi within 1e-5, the
  AR window and the convolved differences within 2e-3 x span;
- the scan started from JAX's init, with JAX's white spectra and BPS
  draws handed over: 1e-5 x span, identical NaN sets;
- the deterministic forecast end to end with blob, domain, tstorm and
  Shi-Tomasi features and AR(2): with JAX's fitted spectra handed over
  1e-5 x span (measured 6.5e-7); with its own fits 0.2 x the largest
  difference of the two packages' spectra, x span, + 1e-5 (measured
  0.02-0.1 x), identical NaN sets;
- probabilistic LINDA by the ``MODEL_PARITY.json`` recipe: CRPS over 4
  leads against the synthetic truth and the spread/error ratio, averaged
  over 8 seeds, within 10% of JAX's (the two draw other random numbers);
"""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu import nowcasts as jnowcasts  # noqa: E402
from pysteps_tpu.feature import blob as jblob  # noqa: E402
from pysteps_tpu.noise.fftgenerators import _spectral_white as j_spectral_white  # noqa: E402
from pysteps_tpu.noise.motion import _laplace as j_laplace  # noqa: E402
from pysteps_tpu.nowcasts import linda as jl  # noqa: E402
from pysteps_tpu.nowcasts import steps as jsteps  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402
from pysteps_tpu_torch.nowcasts import linda as tl  # noqa: E402

SIDE = 64
T = 3
E = 3
VEL = (1.7, 0.6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its many small operators run
    no faster on more, and threads that wait spinning slow the other test
    workers sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(side=SIDE, n_frames=3 + T, evolution=0.2):
    """Rain-rate frames with dry areas (made at 2 side, subsampled) and the
    motion (1.7, 0.6) px a step."""
    frames = make_synthetic_sequence(
        n_frames=n_frames, shape=(2 * side, 2 * side), velocity=(3.4, 1.2), seed=42,
        evolution=evolution,
    )[:, ::2, ::2].astype(np.float32)
    vel = np.zeros((2, side, side), np.float32)
    vel[0], vel[1] = VEL
    return frames, vel


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(ref, out, rel, of_span=True):
    """Within ``rel`` x span (x max |ref| without ``of_span``), identical
    NaN sets; returns the difference over the scale."""
    ref = np.asarray(ref, np.float64)
    out = (out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)).astype(np.float64)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    if of_span:
        scale = float(np.nanmax(ref) - np.nanmin(ref))
    else:
        scale = float(np.nanmax(np.abs(ref)))
    diff = float(np.nanmax(np.abs(np.nan_to_num(ref) - np.nan_to_num(out)))) / max(scale, 1e-30)
    assert diff <= rel, (diff, rel)
    return diff


def _weights(coords, side=SIDE):
    w = jl._compute_window_weights(coords, side, side, 0.2 * side)
    return w.astype(np.float32), (w / w.sum(axis=0, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    """JAX's LINDA init on the 64^2 inputs with its blob features (at most
    4), its one-step hindcast, error model and perturbation parameters, as
    ``pysteps_tpu.nowcasts.linda.forecast`` builds them."""
    frames, vel = _inputs()
    precip = frames[:3]
    coords = np.fliplr(jblob.detection(precip[-1], max_num_features=4)[:, :2])
    w, iw = _weights(coords)
    init = jl._linda_init_core(jnp.asarray(precip), jnp.asarray(vel), jnp.asarray(w),
                               jnp.asarray(iw), ari_order=1)
    init = [np.asarray(x) for x in init]
    pert0 = {"s": np.zeros(1, np.float32), "loc": np.zeros(1, np.float32),
             "std": np.zeros(1, np.float32),
             "ampl": np.zeros((1, SIDE, SIDE // 2 + 1), np.float32),
             "weights": np.ones((1, SIDE, SIDE), np.float32)}
    hind = jl._linda_scan(
        init[8], jnp.asarray(precip[-2]), jnp.asarray(vel), *[jnp.asarray(x) for x in init[:4]],
        jnp.asarray(iw), jnp.asarray(init[4]), jnp.asarray(init[6]),
        jax.random.PRNGKey(0)[None], {k: jnp.asarray(v) for k, v in pert0.items()}, 1, False,
        1, (SIDE, SIDE))
    fct = np.asarray(hind[0, 0])
    obs = precip[-1]
    err = fct / np.where(obs != 0, obs, np.nan)
    err_mask = ((fct >= 1.0) & (obs >= 0.5)) | ((fct >= 0.5) & (obs >= 1.0))
    err = np.where(err_mask, err, np.nan)
    radii = (0.15 * SIDE, 0.25 * SIDE, 0.2 * SIDE)
    pert = jl._estimate_error_model(err, coords, (SIDE, SIDE), *radii)
    return dict(frames=frames, vel=vel, precip=precip, coords=coords, w=w, iw=iw, init=init,
                err=err, radii=radii, pert={k: np.asarray(v) for k, v in pert.items()},
                pert0=pert0, fct=fct)


# --- the convolutions -------------------------------------------------------


@pytest.mark.parametrize("n_feat", [1, 4])
def test_window_weights_and_kernel_spectra(n_feat):
    rng = np.random.default_rng(n_feat)
    coords = rng.uniform(0, SIDE, (n_feat, 2))
    np.testing.assert_array_equal(
        tl._compute_window_weights(coords, SIDE, 48, 9.5),
        jl._compute_window_weights(coords, SIDE, 48, 9.5))
    params = rng.normal(0.0, 1.0, (n_feat, 3)).astype(np.float32)
    ref = np.stack([np.asarray(jl._kernel_ft(jnp.asarray(p), 224, 208)) for p in params])
    out = tl._kernel_ft(_t(params), 224, 208)
    _close(ref, out, 1e-5, of_span=False)
    # (phi, s1, s2) and (phi + pi/2, s2, s1) are one kernel
    p = params[0].copy()
    s1 = np.clip(np.exp(p[1]), 0.1, 10.0)
    s2 = np.clip(np.exp(p[2]), 0.2, 5.0) * s1
    q = np.array([p[0] + np.pi / 2, np.log(s2), np.log(s1 / s2)], np.float32)
    if 0.1 <= s2 <= 10.0 and 0.2 <= s1 / s2 <= 5.0:
        _close(tl._kernel_ft(_t(p), 96, 96).numpy(), tl._kernel_ft(_t(q), 96, 96), 1e-5,
               of_span=False)


def test_convolutions(case):
    k1, k2, n1, _ = (case["init"][i] for i in range(4))
    field = case["precip"][-1]
    mask = case["init"][6]
    _close(jl._conv_kernels(jnp.asarray(field), jnp.asarray(k1)),
           tl._conv_kernels(_t(field), _t(k1)), 1e-5)
    _close(jl._conv_mask_norm(jnp.asarray(k2), jnp.asarray(mask)),
           tl._conv_mask_norm(_t(k2), _t(mask)), 1e-5)
    for norm in (None, n1):
        ref = jl._composite_convolution(jnp.asarray(field), jnp.asarray(k1),
                                        jnp.asarray(case["iw"]),
                                        None if norm is None else jnp.asarray(norm))
        out = tl._composite_convolution(_t(field), _t(k1), _t(case["iw"]),
                                        None if norm is None else _t(norm))
        _close(ref, out, 1e-5)
    # a batch of fields convolves as each field does
    batch = tl._composite_convolution(_t(case["precip"]), _t(k1), _t(case["iw"]), _t(n1))
    one = tl._composite_convolution(_t(case["precip"][0]), _t(k1), _t(case["iw"]), _t(n1))
    _close(one.numpy(), batch[0], 1e-6)


# --- the fits ---------------------------------------------------------------


def test_adam_update_is_optax_bit_for_bit():
    rng = np.random.default_rng(0)
    opt = optax.adam(0.1)
    p = jnp.zeros((4, 3), jnp.float32)
    state = opt.init(p)
    mu = nu = torch.zeros(4, 3)
    tp = torch.zeros(4, 3)
    for count in range(1, 151):
        g = (rng.normal(size=(4, 3)) * 10.0 ** rng.integers(-3, 6, size=(4, 3))).astype(np.float32)
        u, state = opt.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, u)
        tu, mu, nu = tl._adam_update(_t(g), mu, nu, count, 0.1)
        tp = tp + tu
        np.testing.assert_array_equal(np.asarray(u), tu.numpy())
    np.testing.assert_array_equal(np.asarray(p), tp.numpy())


def _jax_fit_loss(params, src, dst, w, mask):
    """The objective of one feature as the JAX module's ``_fit_kernels``
    builds it."""
    m, n = src.shape
    pm, pn = m + jl._KERNEL_PAD, n + jl._KERNEL_PAD
    pad = ((0, jl._KERNEL_PAD), (0, jl._KERNEL_PAD))
    maskf = mask.astype(jnp.float32)
    src_hat = jnp.fft.rfft2(jnp.pad(jnp.where(mask, src, 0.0), pad))
    mask_hat = jnp.fft.rfft2(jnp.pad(maskf, pad))
    kf = jl._kernel_ft(params, pm, pn)
    pred = jnp.fft.irfft2(kf * src_hat, s=(pm, pn))[:m, :n]
    norm = jnp.fft.irfft2(kf * mask_hat, s=(pm, pn))[:m, :n]
    pred = pred / jnp.maximum(norm, 1e-6)
    return jnp.sum(w * (w > 1e-3) * maskf * (pred - jnp.where(mask, dst, 0.0)) ** 2)


def _port_fit_terms(src, dst, w, mask):
    maskf = mask.to(torch.float32)
    src_hat = torch.fft.rfft2(tl._pad(torch.where(mask, src, 0.0)))
    mask_hat = torch.fft.rfft2(tl._pad(maskf))
    return src_hat, mask_hat, torch.where(mask, dst, 0.0), w * (w > 1e-3) * maskf


def test_fit_objective_and_gradient(case):
    diffs = np.diff(case["precip"], axis=0) * case["init"][6]
    mask = case["init"][6]
    params = np.array([[0.4, 0.3, 0.5], [-0.7, 0.9, -0.2], [1.1, -0.3, 0.8],
                       [0.2, 0.1, -0.6]], np.float32)[: len(case["w"])]
    terms = _port_fit_terms(_t(diffs[0]), _t(diffs[1]), _t(case["w"]), _t(mask))
    for f, p in enumerate(params):
        args = (jnp.asarray(diffs[0]), jnp.asarray(diffs[1]), jnp.asarray(case["w"][f]),
                jnp.asarray(mask))
        ref_loss, ref_grad = jax.value_and_grad(_jax_fit_loss)(jnp.asarray(p), *args)
        tp = _t(p).requires_grad_(True)
        loss = tl._fit_loss(tp, terms[0], terms[1], terms[2], terms[3][f])
        (grad,) = torch.autograd.grad(loss, tp)
        assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
        _close(np.asarray(ref_grad), grad, 1e-3, of_span=False)


def test_fit_psi(case):
    diffs = np.diff(case["frames"][:4], axis=0)
    mask = case["init"][6]
    args = (diffs[0], diffs[1], diffs[2])
    ref = jl._fit_psi(*map(jnp.asarray, args[:2]), jnp.asarray(case["w"]), jnp.asarray(mask))
    out = tl._fit_psi(*map(_t, args[:2]), _t(case["w"]), _t(mask))
    _close(ref, out, 1e-5, of_span=False)
    ref2 = jl._fit_psi2(*map(jnp.asarray, args), jnp.asarray(case["w"]), jnp.asarray(mask))
    out2 = tl._fit_psi2(*map(_t, args), _t(case["w"]), _t(mask))
    _close(ref2, out2, 1e-5, of_span=False)
    # the stationarity polygon holds where the LSQ gives psi = (5, 3)
    explode = (diffs[0], diffs[1], 5.0 * diffs[0] + 3.0 * diffs[1])
    out3 = tl._fit_psi2(*map(_t, explode), _t(case["w"]), _t(mask))
    ref3 = jl._fit_psi2(*map(jnp.asarray, explode), jnp.asarray(case["w"]), jnp.asarray(mask))
    _close(ref3, out3, 1e-5, of_span=False)
    psi1, psi2 = out3[:, 0].numpy(), out3[:, 1].numpy()
    assert np.all(psi1 + psi2 <= 0.98 + 1e-6) and np.all(np.abs(psi2) <= 0.98 + 1e-6)


def _aligned_diffs(precip, vel, mask):
    """The differences the init fits kernel 1 on, from JAX's alignment."""
    lagr = np.asarray(jsteps._lagrangian_alignment(jnp.asarray(precip), jnp.asarray(vel)))
    return np.diff(lagr, axis=0) * mask


def _fit_objective(spectra, src, dst, w, mask):
    """Each feature's objective of the kernel fit at ``spectra``: the
    weighted squared error of the mask-renormalized convolution of
    ``src`` against ``dst`` (numpy (F,))."""
    k = _t(spectra)
    src = np.where(mask, src, 0.0).astype(np.float32)
    pred = (tl._conv_kernels(_t(src), k) / tl._conv_mask_norm(k, _t(mask))).numpy()
    return np.sum(w * (w > 1e-3) * mask * (pred - np.where(mask, dst, 0.0)) ** 2, axis=(1, 2))


@pytest.mark.parametrize("features", ["blob", "domain"])
def test_fit_kernels(case, features):
    """Kernel 1's fit on the init's inputs, against JAX's: the objective
    each fit reaches within 1% of the other's.  The fit follows rounding
    from its first step (see ``_fit_kernels``).  With blob features the
    reference is JAX's init: one feature's spectra lie 0.38 of their
    largest value from its fit there (0.69 from JAX's ``_fit_kernels``
    called alone, which lands 0.86 from its own init), at objectives
    1598.2 against 1590.8 (1615.5 alone).  With the domain as one feature
    both fits run sigma1 and the ratio into their clips (10 and 5 px) and
    settle on phi optima 1.7 rad apart whose objectives differ by 1e-4
    (the deterministic forecast test bounds what that moves)."""
    mask = case["init"][6]
    diffs = _aligned_diffs(case["precip"], case["vel"], mask)
    if features == "blob":
        w = case["w"]
        ref = case["init"][0]
    else:
        w = _weights(np.zeros((1, 2)))[0]
        ref = np.asarray(jl._fit_kernels(jnp.asarray(diffs[0]), jnp.asarray(diffs[1]),
                                         jnp.asarray(w), jnp.asarray(mask)))
    out = tl._fit_kernels(_t(diffs[0]), _t(diffs[1]), _t(w), _t(mask))
    assert out.shape == ref.shape
    loss = _fit_objective(out, diffs[0], diffs[1], w, mask)
    loss_ref = _fit_objective(ref, diffs[0], diffs[1], w, mask)
    assert np.all(np.abs(loss - loss_ref) <= 0.01 * loss_ref), (loss, loss_ref)


def _hand_over_fits(monkeypatch, *spectra):
    """Make the port's ``_fit_kernels`` return ``spectra`` in turn, and
    after them fit as before; returns the (src, dst) of each call."""
    calls = []
    fit = tl._fit_kernels

    def handed(src, dst, weights, mask, **kw):
        calls.append((src.numpy(), dst.numpy()))
        if len(calls) <= len(spectra):
            return _t(spectra[len(calls) - 1])
        return fit(src, dst, weights, mask, **kw)

    monkeypatch.setattr(tl, "_fit_kernels", handed)
    return calls


def test_init_core(case, monkeypatch):
    """The init on JAX's fitted spectra (its kernels 1 and 2) handed over."""
    ref = case["init"]
    calls = _hand_over_fits(monkeypatch, ref[0], ref[1])
    out = tl._linda_init_core(_t(case["precip"]), _t(case["vel"]), _t(case["w"]),
                              _t(case["iw"]), ari_order=1)
    assert len(calls) == 2
    for i in (0, 1):  # the kernel spectra
        _close(ref[i], out[i], 5e-3, of_span=False)
    for i in (2, 3):  # their mask normalizers
        _close(ref[i], out[i], 5e-3, of_span=False)
    _close(ref[4], out[4], 1e-5, of_span=False)  # psi (the fit's clip binds here)
    for i in (5, 8):  # the AR window and the convolved differences
        _close(ref[i], out[i], 2e-3)
    np.testing.assert_array_equal(ref[6], out[6].numpy())
    _close(ref[7], out[7], 1e-6)


def test_fit_kernel_2_on_jax_kernel_1(case, monkeypatch):
    """Kernel 2's fit, on the one-step forecast the port's init makes from
    JAX's kernel 1: its objective within 1% of that of JAX's kernel 2 on
    the same inputs (measured within 1e-6)."""
    ref = case["init"]
    calls = _hand_over_fits(monkeypatch, ref[0])
    out = tl._linda_init_core(_t(case["precip"]), _t(case["vel"]), _t(case["w"]),
                              _t(case["iw"]), ari_order=1)
    assert len(calls) == 2
    src, dst = calls[1]
    loss = _fit_objective(out[1], src, dst, case["w"], ref[6])
    loss_ref = _fit_objective(ref[1], src, dst, case["w"], ref[6])
    assert np.all(np.abs(loss - loss_ref) <= 0.01 * loss_ref), (loss, loss_ref)


def test_init_core_ari2_and_input_nans(case):
    """AR(2) on 4 frames with NaN cells: the advection mask equal, psi
    (two maps) and the AR window close."""
    frames, vel = case["frames"], case["vel"]
    precip = frames[:4].copy()
    precip[1, 10:14, 40:44] = np.nan
    precip[3, 50:52, 5:9] = np.nan
    w, iw = _weights(np.zeros((1, 2)))
    ref = [np.asarray(x) for x in jl._linda_init_core(
        jnp.asarray(precip), jnp.asarray(vel), jnp.asarray(w), jnp.asarray(iw), ari_order=2)]
    out = tl._linda_init_core(_t(precip), _t(vel), _t(w), _t(iw), ari_order=2)
    np.testing.assert_array_equal(ref[6], out[6].numpy())
    assert not ref[6].all()
    assert out[4].shape == (2, SIDE, SIDE)
    _close(ref[4], out[4], 5e-3, of_span=False)
    _close(ref[5], out[5], 5e-3)


# --- the error model and the perturbations ----------------------------------


def test_error_model(case):
    out = tl._estimate_error_model(case["err"], case["coords"], (SIDE, SIDE), *case["radii"],
                                   device="cpu")
    for key in ("s", "loc", "std", "weights"):
        _close(case["pert"][key], out[key], 1e-6, of_span=False)
    _close(case["pert"]["ampl"], out["ampl"], 1e-5, of_span=False)
    assert (out["std"] > 0).any()


def test_perturbations_from_jax_white(case):
    keys = jax.random.split(jax.random.PRNGKey(5), E)
    pp = {k: jnp.asarray(v) for k, v in case["pert"].items()}
    ref = np.stack([np.asarray(jl._generate_error_perturbations(k, pp, (SIDE, SIDE)))
                    for k in keys])
    white = np.stack([np.asarray(j_spectral_white(k, (SIDE, SIDE))) for k in keys])
    out = tl._perturbations_from_white(
        _t(white), {k: _t(v) for k, v in case["pert"].items()}, (SIDE, SIDE))
    _close(ref, out, 1e-5)
    assert float(out.std()) > 0.01


# --- the scan ---------------------------------------------------------------


def _jax_member_whites(seed, n_members, n_steps):
    """The white spectra JAX's scan draws: (steps, members, m, rf)."""
    out = []
    keys = [jax.random.fold_in(jax.random.PRNGKey(seed), i) for i in range(n_members)]
    for _ in range(n_steps):
        step = []
        for i, key in enumerate(keys):
            keys[i], k_pert = jax.random.split(key)
            step.append(np.asarray(j_spectral_white(k_pert, (SIDE, SIDE))))
        out.append(np.stack(step))
    return out


@pytest.mark.parametrize("mode", ["deterministic", "perturbed", "perturbed_bps"])
def test_scan_from_jax_init_and_draws(case, mode, monkeypatch):
    """The port's loop from JAX's init, on JAX's white spectra and BPS
    draws, against JAX's loop: 1e-5 x span."""
    init = case["init"]
    vel = case["vel"]
    add = mode != "deterministic"
    bps = mode == "perturbed_bps"
    n_members = E if add else 1
    pert = case["pert"] if add else case["pert0"]
    seed = 17
    jkw, tkw = {}, {}
    if bps:
        vkeys = jax.random.split(jax.random.PRNGKey(seed + 7), 2 * n_members)
        eps_par = jax.vmap(j_laplace)(vkeys[:n_members])
        eps_perp = jax.vmap(j_laplace)(vkeys[n_members:])
        v = jnp.asarray(vel)
        Nv = jnp.linalg.norm(v, axis=0)
        V_n = jnp.where(Nv[None] > 1e-12, v / jnp.maximum(Nv[None], 1e-12), 0.0)
        V_perp = jnp.stack([-V_n[1], V_n[0]])
        coeffs = ((10.88, 0.23, -7.68), (5.76, 0.31, -2.72))
        vsf = 60.0 / (5 * 1.0)
        jkw = dict(vel_pert=True, vp_coeffs=coeffs, eps_par=eps_par, eps_perp=eps_perp,
                   V_n=V_n, V_perp=V_perp, vsf=jnp.float32(vsf), timestep_min=jnp.float32(5.0))
        tkw = dict(vel_pert=True, vp_coeffs=coeffs, eps_par=_t(eps_par), eps_perp=_t(eps_perp),
                   V_n=_t(V_n), V_perp=_t(V_perp), vsf=vsf, timestep_min=5.0)
    member_keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
        jnp.arange(n_members))
    ref = np.asarray(jl._linda_scan(
        jnp.asarray(init[5]), jnp.asarray(init[7]), jnp.asarray(vel),
        *[jnp.asarray(x) for x in init[:4]], jnp.asarray(case["iw"]), jnp.asarray(init[4]),
        jnp.asarray(init[6]), member_keys, {k: jnp.asarray(v) for k, v in pert.items()}, T,
        add, n_members, (SIDE, SIDE), **jkw))
    whites = iter(_jax_member_whites(seed, n_members, T))
    monkeypatch.setattr(tl, "_member_white", lambda gens, shape: _t(next(whites)))
    out = tl._linda_scan(
        _t(init[5]), _t(init[7]), _t(vel), *[_t(x) for x in init[:4]], _t(case["iw"]),
        _t(init[4]), _t(init[6]), [None] * n_members, {k: _t(v) for k, v in pert.items()},
        T, add, n_members, (SIDE, SIDE), **tkw)
    assert out.shape == (n_members, T, SIDE, SIDE)
    _close(ref, out, 1e-5)
    if add:
        assert float(torch.nanmean(torch.abs(out[0] - out[1]))) > 0.0


# --- the forecast -----------------------------------------------------------


FEATURE_KW = {"tstorm": {"minref": 1.0, "minmax": 3.0, "minsize": 10, "maxref": 8.0,
                         "mindiff": 1.0}}


@pytest.mark.parametrize("feature_method, ari_order", [
    ("blob", 1), ("domain", 1), ("tstorm", 1), ("shitomasi", 1), ("blob", 2)])
def test_deterministic_forecast(feature_method, ari_order, capsys, monkeypatch):
    """The deterministic forecast end to end: with JAX's two fitted kernel
    spectra handed over, within 1e-5 x span (measured 6.5e-7); with its
    own fits, within 0.2 x the largest difference of the two packages'
    spectra, x span, + 1e-5 (measured 0.02-0.1 x: 1.6e-4 x span with blob
    features, 1.9e-2 with the domain, whose fit is not well posed, see
    :func:`test_fit_kernels`)."""
    frames, vel = _inputs()
    precip = frames[:ari_order + 2]
    kw = dict(add_perturbations=False, feature_method=feature_method, max_num_features=4,
              feature_kwargs=FEATURE_KW.get(feature_method), ari_order=ari_order)
    jax_kernels = []
    real_init = jl._linda_init_core

    def record_init(*args, **kwargs):
        out = real_init(*args, **kwargs)
        jax_kernels.extend([np.asarray(out[0]), np.asarray(out[1])])
        return out

    monkeypatch.setattr(jl, "_linda_init_core", record_init)
    ref = np.asarray(jnowcasts.get_method("linda")(precip, vel, T, **kw))
    n_ref = capsys.readouterr().out
    own_kernels = []
    real_fit = tl._fit_kernels

    def record_fit(*args, **kwargs):
        own_kernels.append(real_fit(*args, **kwargs))
        return own_kernels[-1]

    monkeypatch.setattr(tl, "_fit_kernels", record_fit)
    out = tnowcasts.get_method("linda")(precip, vel, T, device="cpu", **kw)
    assert capsys.readouterr().out == n_ref  # "Detected N features."
    assert out.shape == (T, SIDE, SIDE) and out.device.type == "cpu"
    handed = iter(jax_kernels)
    monkeypatch.setattr(tl, "_fit_kernels", lambda *a, **k: _t(next(handed)))
    _close(ref, tnowcasts.get_method("linda")(precip, vel, T, device="cpu", **kw), 1e-5)
    dk = max(float(np.abs(a - b.numpy()).max()) for a, b in zip(jax_kernels, own_kernels))
    _close(ref, out, 0.2 * dk + 1e-5)


def _crps(ens, obs):
    ens = ens.reshape(ens.shape[0], -1)
    obs = obs.reshape(-1)
    ok = np.all(np.isfinite(ens), axis=0) & np.isfinite(obs)
    ens, obs = ens[:, ok], obs[ok]
    n = ens.shape[0]
    term1 = np.abs(ens - obs).mean(axis=0)
    srt = np.sort(ens, axis=0)
    pair = ((2 * np.arange(n) + 1 - n)[:, None] * srt).sum(axis=0) / n**2
    return float((term1 - pair).mean())


def _scores(fc, truth):
    """CRPS over all leads and the spread/error ratio, in rain rate."""
    fc = np.asarray(fc, np.float64)
    crps = np.mean([_crps(fc[:, t], truth[t]) for t in range(fc.shape[1])])
    spread = np.nanmean(np.nanstd(fc, axis=0, ddof=1))
    err = np.sqrt(np.nanmean((np.nanmean(fc, axis=0) - truth) ** 2))
    return crps, spread / err


def test_probabilistic_crps_law():
    side, leads = 96, 4
    frames, vel = _inputs(side=side, n_frames=3 + leads)
    truth = frames[3:]
    kw = dict(add_perturbations=True, n_ens_members=8, feature_method="blob",
              max_num_features=4, kmperpixel=1.0, timestep=5)
    j, t = [], []
    for seed in (11, 22, 33, 44, 55, 66, 77, 88):
        j.append(_scores(jnowcasts.get_method("linda")(frames[:3], vel, leads, seed=seed, **kw),
                         truth))
        out = tnowcasts.get_method("linda")(frames[:3], vel, leads, seed=seed, device="cpu",
                                            **kw)
        assert out.shape == (8, leads, side, side)
        t.append(_scores(out.numpy(), truth))
    (c_j, r_j), (c_t, r_t) = np.mean(j, axis=0), np.mean(t, axis=0)
    assert abs(c_t - c_j) / c_j <= 0.1, (c_t, c_j)
    assert abs(r_t - r_j) / r_j <= 0.1, (r_t, r_j)


def test_forecast_options_and_errors():
    frames, vel = _inputs()
    f = tnowcasts.get_method("linda")
    kw = dict(add_perturbations=False, feature_method="domain", device="cpu")
    full = f(frames[:3], vel, 3, **kw)
    # the callback gets numpy frames of the forecast
    got = []
    res, init_s, loop_s = f(frames[:3], vel, 3, callback=got.append, measure_time=True,
                            return_output=False, **kw)
    assert res is None and init_s > 0 and loop_s > 0
    assert len(got) == 3 and all(isinstance(g, np.ndarray) for g in got)
    np.testing.assert_array_equal(np.stack(got), full.numpy())
    # fractional lead times interpolate the unit leads as JAX's do: 0.5
    # takes lead 1, 2.5 the mean of leads 2 and 3
    frac = f(frames[:3], vel, [0.5, 2.0, 2.5], **kw)
    np.testing.assert_array_equal(frac[0].numpy(), full[0].numpy())
    np.testing.assert_array_equal(frac[1].numpy(), full[1].numpy())
    np.testing.assert_allclose(frac[2].numpy(), 0.5 * (full[1] + full[2]).numpy(), atol=1e-6)
    # probabilistic callback: (E, m, n) numpy frames
    got = []
    ens = f(frames[:3], vel, 2, add_perturbations=True, n_ens_members=2, feature_method="domain",
            vel_pert_method=None, callback=got.append, seed=3, device="cpu")
    assert ens.shape == (2, 2, SIDE, SIDE) and got[0].shape == (2, SIDE, SIDE)
    np.testing.assert_array_equal(np.stack(got, axis=1), ens.numpy())
    for bad, err in (
            (dict(ari_order=3), ValueError), (dict(feature_method="harris"), NotImplementedError),
            (dict(add_perturbations=True, kmperpixel=None), ValueError)):
        with pytest.raises(err):
            f(frames[:3], vel, 2, **dict(kw, **bad))
    with pytest.raises(ValueError):
        f(frames[:1], vel, 2, **kw)


def test_signature_is_jax_plus_device():
    j_params = list(inspect.signature(jl.forecast).parameters)
    t_params = list(inspect.signature(tl.forecast).parameters)
    assert t_params == j_params + ["device"]
