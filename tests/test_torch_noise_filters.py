"""The noise filters, generators and the std adjustment of the PyTorch
port against the JAX package on the same numpy inputs, at 128^2 (96 x 112
where a shape is not square):

- the nonparametric filter with ``donorm`` and ``use_full_fft``: rtol 1e-4
  (with 1e-4 x max|ref| absolute);
- the parametric filter: its radial PSD rtol 1e-4, its 4 fitted
  parameters rtol 1e-3 (1e-6 absolute for one fitted to its bound 0), the
  filter rtol 1e-3;
- the SSFT and nested stacks and the generator's masks: rtol 1e-4 (with
  1e-4 x max|ref| absolute);
- the SSFT and the full-plane generators with the JAX draws handed over:
  1e-4 x max|ref|;
- ``compute_noise_stddev_adjs`` with the JAX draws handed over: rtol 1e-4;
- ``initialize_bps`` / ``generate_bps`` with the JAX Laplace draws: rtol
  1e-6;
- ``noise.get_method`` for every name, and an unknown one.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu import cascade as jcascade  # noqa: E402
from pysteps_tpu import noise as jnoise  # noqa: E402
from pysteps_tpu.noise import fftgenerators as jfft  # noqa: E402
from pysteps_tpu.noise import motion as jmotion  # noqa: E402
from pysteps_tpu.noise import utils as jnutils  # noqa: E402
from pysteps_tpu_torch import noise as tnoise  # noqa: E402
from pysteps_tpu_torch.noise import fftgenerators as tfft  # noqa: E402
from pysteps_tpu_torch.noise import motion as tmotion  # noqa: E402
from pysteps_tpu_torch.noise import utils as tnutils  # noqa: E402


def _fields(shape=(128, 128), seed=42):
    """Three radar-like frames in dB whose columns from 3/8 of the width on
    are dry (-15 dB), so that some SSFT windows are too dry for a filter of
    their own."""
    f = make_synthetic_sequence(n_frames=3, shape=shape, velocity=(2.0, 1.0), seed=seed)
    f[:, :, 3 * shape[1] // 8 :] = 0.0
    return np.where(f >= 0.1, 10 * np.log10(np.maximum(f, 0.1)), -15.0).astype(np.float32)


def _close(ref, out, rtol=1e-4, of_max=True):
    ref = np.asarray(ref, np.float64)
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    atol = rtol * float(np.abs(ref).max()) if of_max else 0.0
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("donorm, full", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("win_fun, rm_rdisc", [("tukey", True), (None, False)])
def test_nonparam_filter(donorm, full, win_fun, rm_rdisc):
    x = _fields((96, 112))
    kw = dict(donorm=donorm, use_full_fft=full, win_fun=win_fun, rm_rdisc=rm_rdisc)
    ref = jfft.initialize_nonparam_2d_fft_filter(x, **kw)
    out = tfft.initialize_nonparam_2d_fft_filter(torch.from_numpy(x), **kw)
    assert out["input_shape"] == ref["input_shape"] and out["use_full_fft"] == full
    _close(ref["field"], out["field"])


@pytest.mark.parametrize("kw", [{}, {"win_fun": "tukey", "weighted": True},
                                {"rm_rdisc": True}])
@pytest.mark.parametrize("shape", [(128, 128), (96, 112)])
def test_param_filter(kw, shape):
    x = _fields(shape)
    taper = np.ones(shape, np.float32)
    if kw.get("win_fun"):
        taper = jfft.tapering_utils.compute_window_function(*shape, "tukey").astype(np.float32)
    psd_ref = np.asarray(jfft._param_psd_device(jnp.asarray(x), taper,
                                                rm_rdisc=bool(kw.get("rm_rdisc"))))
    psd_out = tfft._param_psd(torch.from_numpy(x), torch.from_numpy(taper),
                              rm_rdisc=bool(kw.get("rm_rdisc")))
    _close(psd_ref, psd_out, of_max=False)
    ref = jfft.initialize_param_2d_fft_filter(jnp.asarray(x), **kw)
    out = tfft.initialize_param_2d_fft_filter(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(out["pars"], ref["pars"], rtol=1e-3, atol=1e-6)
    _close(ref["field"], out["field"], rtol=1e-3, of_max=False)
    assert out["use_full_fft"] and out["model"] == "power-law"
    with pytest.raises(ValueError):
        tfft.initialize_param_2d_fft_filter(torch.from_numpy(x), model="spline")


@pytest.mark.parametrize("win_size, overlap", [(64, 0.3), ((48, 40), 0.1)])
def test_ssft_stack(win_size, overlap):
    x = _fields()
    kw = dict(win_size=win_size, overlap=overlap)
    ref = jfft.initialize_nonparam_2d_ssft_filter(x, **kw)
    out = tfft.initialize_nonparam_2d_ssft_filter(torch.from_numpy(x), **kw)
    assert out["field"].shape == ref["field"].shape
    _close(ref["field"], out["field"])
    # some windows are wet enough for a filter of their own, some are not
    F = np.asarray(ref["field"]).reshape(-1, 128, 128)
    glob = jfft.initialize_nonparam_2d_fft_filter(
        jfft._prep_field(x, True), donorm=True, use_full_fft=True)["field"]
    same = [np.allclose(Fi, glob) for Fi in F]
    assert any(same) and not all(same)
    masks = tfft._ssft_gen_masks(out["field"].shape, (128, 128), 0.2, "tukey")
    _close(np.asarray(jfft._ssft_gen_masks(ref["field"].shape, (128, 128), 0.2, "tukey"),
                      np.float32), masks, rtol=0.0)


@pytest.mark.parametrize("max_level", [1, 2])
def test_nested_stack(max_level):
    x = _fields()
    ref = jfft.initialize_nonparam_2d_nested_filter(x, max_level=max_level)
    out = tfft.initialize_nonparam_2d_nested_filter(torch.from_numpy(x), max_level=max_level)
    assert out["field"].shape == ref["field"].shape == (2**max_level,) * 2 + (128, 128)
    _close(ref["field"], out["field"])


def _jax_normals(keys, shape):
    return np.stack([np.asarray(jax.random.normal(k, shape, dtype=jnp.float32)) for k in keys])


@pytest.mark.parametrize("chunk_bytes", [None, 1])
def test_ssft_noise_with_jax_draws(monkeypatch, chunk_bytes):
    x = _fields()
    F = jfft.initialize_nonparam_2d_ssft_filter(x, win_size=64)
    masks = jfft._ssft_gen_masks(F["field"].shape, (128, 128), 0.2, "tukey")
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    white = _jax_normals(keys, (128, 128))
    monkeypatch.setattr(tfft, "_white_normal", lambda g, s, b: torch.from_numpy(white))
    if chunk_bytes is not None:  # one member a chunk: the same result
        monkeypatch.setattr(tfft, "_SSFT_CHUNK_BYTES", chunk_bytes)
    out = tfft._generate_ssft_noise(
        None, torch.from_numpy(np.array(F["field"])),
        torch.from_numpy(masks.astype(np.float32)), (128, 128), 3)
    for b in range(3):
        ref = np.asarray(jfft._generate_ssft_noise(
            keys[b], F["field"], jnp.asarray(masks, jnp.float32), (128, 128)))
        assert np.abs(out[b].numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    # the public generator: one field from a seed's draw
    monkeypatch.setattr(tfft, "_white_normal", lambda g, s, b: torch.from_numpy(white[:1]))
    Ft = dict(F, field=torch.from_numpy(np.array(F["field"])))
    one = tfft.generate_noise_2d_ssft_filter(Ft, seed=1)
    ref = np.asarray(jfft._generate_ssft_noise(keys[0], F["field"], jnp.asarray(masks, jnp.float32),
                                               (128, 128)))
    assert one.shape == (128, 128)
    assert np.abs(one.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    with pytest.raises(NotImplementedError):
        tfft.generate_noise_2d_ssft_filter(Ft, domain="spectral")


@pytest.mark.parametrize("domain", ["spatial", "spectral"])
@pytest.mark.parametrize("standardize", [False, True])
def test_full_plane_noise_with_jax_draws(monkeypatch, domain, standardize):
    x = _fields()
    F = jfft.initialize_param_2d_fft_filter(jnp.asarray(x))
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    if domain == "spatial":
        draws = _jax_normals(keys, (128, 128))
        monkeypatch.setattr(tfft, "_white_normal", lambda g, s, b: torch.from_numpy(draws))
    else:
        draws = np.stack([np.asarray(jfft._spectral_phase_white(k, (128, 128), use_full_fft=True))
                          for k in keys])
        monkeypatch.setattr(tfft, "_spectral_phase_white",
                            lambda g, s, b, use_full_fft=False: torch.from_numpy(draws))
    filt = torch.from_numpy(np.array(F["field"]))
    out = tfft._generate_fft_noise(None, filt, (128, 128), 2, domain=domain,
                                   standardize=standardize, use_full_fft=True).numpy()
    for b in range(2):
        ref = np.asarray(jfft._generate_fft_noise(keys[b], F["field"], (128, 128), True,
                                                  domain=domain, standardize=standardize))
        assert np.abs(out[b] - ref).max() <= 1e-4 * np.abs(ref).max()
    one = tfft.generate_noise_2d_fft_filter(
        {"field": filt, "input_shape": (128, 128), "use_full_fft": True}, domain=domain)
    assert one.shape == (128, 128)
    with pytest.raises(ValueError):
        tfft.generate_noise_2d_fft_filter(
            {"field": filt, "input_shape": (128, 128), "use_full_fft": True}, domain="wavelet")


@pytest.mark.parametrize("method", ["nonparametric", "parametric", "ssft", "nested"])
@pytest.mark.parametrize("conditional", [True, False])
def test_noise_stddev_adjs_with_jax_draws(monkeypatch, method, conditional):
    x = _fields()
    init_j = jnoise.get_method(method)[0]
    kw = {"ssft": dict(win_size=64), "nested": dict(max_level=2)}.get(method, {})
    Fj = init_j(jnp.asarray(x) if method == "parametric" else x, **kw)
    bp = jcascade.get_method("gaussian")((128, 128), 6)
    num_iter = 4
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jnutils.compute_noise_stddev_adjs(
        x[-1], -10.0, -15.0, bp, None, Fj, None, num_iter, conditional=conditional, key=key))
    keys = jax.random.split(key, num_iter)
    if Fj["use_full_fft"]:
        draws = _jax_normals(keys, (128, 128))
        monkeypatch.setattr(tfft, "_white_normal", lambda g, s, b: torch.from_numpy(draws))
    else:
        draws = np.stack([np.asarray(jfft._spectral_white(k, (128, 128))) for k in keys])
        monkeypatch.setattr(tfft, "_spectral_white", lambda g, s, b: torch.from_numpy(draws))
    Ft = dict(Fj, field=torch.from_numpy(np.array(Fj["field"])))
    out = tnutils.compute_noise_stddev_adjs(
        torch.from_numpy(x[-1]), -10.0, -15.0,
        {"weights_2d": np.array(bp["weights_2d"])}, None, Ft, None, num_iter,
        conditional=conditional)
    assert out.shape == (6,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)


def test_bps_with_jax_draws(monkeypatch):
    rng = np.random.default_rng(3)
    V = rng.normal(size=(2, 32, 40)).astype(np.float32)
    V[:, :2, :2] = 0.0
    key = jax.random.PRNGKey(4)
    ref = jmotion.initialize_bps(jnp.asarray(V), 1.0, 5.0, key=key)
    draws = iter([torch.tensor(float(ref["eps_par"])), torch.tensor(float(ref["eps_perp"]))])
    monkeypatch.setattr(tmotion, "_laplace", lambda g, shape=(): next(draws))
    out = tmotion.initialize_bps(torch.from_numpy(V), 1.0, 5.0, seed=0)
    for k in ("vsf", "p_par", "p_perp"):
        assert out[k] == pytest.approx(ref[k])
    for k in ("eps_par", "eps_perp", "V_par", "V_perp"):
        _close(ref[k], out[k], rtol=1e-6)
    for t in (5.0, 30.0):
        _close(jmotion.generate_bps(ref, t), tmotion.generate_bps(out, t), rtol=1e-6)
    with pytest.raises(ValueError):
        tmotion.initialize_bps(torch.from_numpy(V[0]), 1.0, 5.0, seed=0)


def test_bps_draws_from_the_generator():
    gen = torch.Generator().manual_seed(11)
    a = tmotion.initialize_bps(torch.ones(2, 8, 8), 1.0, 5.0, generator=gen)
    b = tmotion.initialize_bps(torch.ones(2, 8, 8), 1.0, 5.0, seed=11)
    assert float(a["eps_par"]) == float(b["eps_par"])
    assert float(a["eps_par"]) != float(a["eps_perp"])


@pytest.mark.parametrize("name", ["parametric", "nonparametric", "ssft", "nested", "bps",
                                  "SSFT"])
def test_noise_registry(name):
    init, gen = tnoise.get_method(name)
    ji, jg = jnoise.get_method(name)
    assert (init.__name__, gen.__name__) == (ji.__name__, jg.__name__)
    assert init.__module__.startswith("pysteps_tpu_torch.")


def test_noise_registry_unknown():
    with pytest.raises(ValueError):
        tnoise.get_method("pink")
    with pytest.raises(ValueError):
        tnoise.get_method(None)
