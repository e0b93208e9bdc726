"""The motion solvers of ``pysteps_tpu_torch.motion`` against the JAX
package's on the CPU, and against the synthetic truth.

Inputs: ``tests/test_motion.py``'s own frames (the synthetic dB sequence
of ``tests/helpers.py`` at 200^2, velocity (2, 1), seed 3; the frame
counts and options of its cases), and 128^2 frames of the same sequence
for the other options.  Run as a script, it prints each solver's
relative RMSE on the JAX bench's 512^2 inputs in both packages
(:func:`bench_truth`).  Tolerances:

- LK, DARTS, Proesmans, Farneback and constant: the flow within 1e-3 px
  of JAX's at every pixel (float32 sums in other orders);
- VET: the RMS of the flow's difference from JAX's within 0.15 x |v|
  (0.335 px).  Its Adam loop amplifies rounding: the first step already
  differs in the last bits (optax rounds the bias corrections in
  float32, PyTorch in float64), and from the global-shift seed the cost
  rises steeply within a few steps, so two float32 trajectories part
  while both meet the truth bound;
- every method meets ``tests/test_motion.py``'s bound on the flow's
  relative RMSE against (2, 1) 20 px from the borders (LK, VET,
  Proesmans, Farneback 0.1, DARTS 0.6, constant 0.05).

The card's branches run here through the plain K1 and are held against
the same branches of the JAX package, whose ``_resample`` takes its plain
path on the CPU: Proesmans' and Farneback's ``use_shift=True`` solves
(128^2) within 1e-3 px at every pixel, and twenty of Proesmans' iterations
at a 4 px bound that the flows pass (64^2) within 1e-4 px; VET's recentred shift cost
(``max_disp=8, center_shift=(1, 2)``, one and two pairs, 128^2) within
1e-5 of the value and 1e-5 of the gradient's largest component, and five
of its Adam steps within 2e-5 px (the trajectories part only later: the
warp's gradient jumps where a displacement crosses a whole pixel);
VET's whole card branch (``max_disp="shift"``) against JAX's
``max_disp=16`` path (``tests/test_motion.py:73-83``) and its own
``"shift"`` branch at the RMS bound above.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu import motion as jmotion  # noqa: E402
from pysteps_tpu.motion import darts as jdarts  # noqa: E402
from pysteps_tpu.motion import farneback as jfarneback  # noqa: E402
from pysteps_tpu.motion import proesmans as jproesmans  # noqa: E402
from pysteps_tpu.motion import vet as jvet  # noqa: E402
from pysteps_tpu_torch import motion as tmotion  # noqa: E402
from pysteps_tpu_torch.motion import farneback as tfarneback  # noqa: E402
from pysteps_tpu_torch.motion import proesmans as tproesmans  # noqa: E402
from pysteps_tpu_torch.motion import vet as tvet  # noqa: E402

SPEED = float(np.hypot(2.0, 1.0))
PX_TOL = 1e-3
VET_REL_RMS = 0.15
VET_COST_RTOL = 1e-5
VET_ADAM_PX = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch calls: the tier-1 run
    shares the machine's cores among its workers, and a pool of one thread
    a core in each worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# tests/test_motion.py's cases: (method, frames, truth bound, options)
CASES = {
    "lucaskanade": (3, 0.1, {}),
    "vet": (2, 0.1, {"options": {"maxiter": 150}, "verbose": False}),
    "proesmans": (2, 0.1, {"verbose": False}),
    "darts": (9, 0.6, {"verbose": False}),
    "farneback": (2, 0.1, {}),
    "constant": (2, 0.05, {}),
}


def _db(side, n_frames=9):
    f = make_synthetic_sequence(n_frames=n_frames, shape=(side, side), velocity=(2.0, 1.0),
                                seed=3)
    return (10.0 * np.log10(np.maximum(f, 0.1))).astype(np.float32)


@pytest.fixture(scope="module")
def synthetic_db():
    return _db(200)


@pytest.fixture(scope="module")
def small_db():
    return _db(128, 3)


@pytest.fixture(scope="module")
def flows(synthetic_db):
    """The port's (``jax=False``) or JAX's flow of each case, computed
    once."""
    cache = {}

    def get(method, jax=False):
        if (method, jax) not in cache:
            n_frames, _, kw = CASES[method]
            frames = synthetic_db[:n_frames]
            if jax:
                flow = np.asarray(jmotion.get_method(method)(frames, **kw))
            else:
                flow = tmotion.get_method(method)(frames, device="cpu", **kw)
                assert isinstance(flow, torch.Tensor) and flow.device.type == "cpu"
                flow = flow.numpy()
            cache[method, jax] = flow
        return cache[method, jax]

    return get


def _rel_rmse(uv, margin=20):
    u = uv[0][margin:-margin, margin:-margin]
    v = uv[1][margin:-margin, margin:-margin]
    return float(np.sqrt(np.mean((u - 2.0) ** 2 + (v - 1.0) ** 2)) / SPEED)


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


# constant is held against JAX at 128^2 (test_constant_max_shift): JAX's
# search over 441 shifts at 200^2 alone takes most of this file's time
@pytest.mark.parametrize("method", sorted(set(CASES) - {"constant"}))
def test_flow_against_jax(flows, method):
    port, ref = flows(method), flows(method, jax=True)
    assert port.shape == ref.shape == (2, 200, 200)
    if method == "vet":
        assert _rms(port, ref) <= VET_REL_RMS * SPEED
    else:
        assert np.abs(port - ref).max() <= PX_TOL


@pytest.mark.parametrize("method", sorted(CASES))
def test_flow_against_truth(flows, method):
    port = flows(method)
    bound = CASES[method][1]
    assert _rel_rmse(port) < bound, method


def test_vet_card_branch(synthetic_db):
    """The card's branch of VET on the CPU: the recentred shift cost
    through the plain K1 and AxisResample's backward."""
    frames = synthetic_db[:2]
    port = tvet.vet(frames, options={"maxiter": 100}, verbose=False, max_disp="shift",
                    device="cpu").numpy()
    bounded = np.asarray(jvet.vet(frames, options={"maxiter": 100}, verbose=False,
                                  max_disp=16))
    shifted = np.asarray(jvet.vet(frames, options={"maxiter": 100}, verbose=False,
                                  max_disp="shift"))
    assert _rel_rmse(port) < 0.1
    assert _rms(port, bounded) <= VET_REL_RMS * SPEED
    assert _rms(port, shifted) <= VET_REL_RMS * SPEED


@pytest.mark.parametrize("method", ["proesmans", "farneback"])
def test_shift_branch_against_jax(small_db, method):
    """The card's branch (``use_shift=True``: the shift warp, here through
    the plain K1) against the JAX package's same branch."""
    a, b = small_db[-2], small_db[-1]
    if method == "proesmans":
        port = tproesmans._proesmans_full(torch.tensor(a), torch.tensor(b), 50.0, 6, 100, 0.0,
                                          True, False)
        ref = jproesmans._proesmans_full(jnp.asarray(a), jnp.asarray(b), jnp.float32(50.0), 6,
                                         100, 0.0, True, False)
    else:
        port = tfarneback._farneback_full(torch.tensor(a), torch.tensor(b), 4, 5, 7, 1.5, 32,
                                          True)
        ref = jfarneback._farneback_full(jnp.asarray(a), jnp.asarray(b), 4, 5, 7, 1.5, 32, True)
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape == (2, 128, 128)
    assert np.abs(port - ref).max() <= PX_TOL
    assert _rel_rmse(port) < CASES[method][1]


def test_proesmans_level_shift_against_jax():
    """Twenty Jacobi iterations of one level through the shift warp with a
    bound (4 px) that rough start flows of up to about 8 px pass: the
    clipped taps of both directions' batch against JAX's two warps."""
    x = _bench_db(64, 2)
    R = ((x - x.min()) * (255.0 / (x.max() - x.min()))).astype(np.float32)
    V0 = np.random.default_rng(0).normal(0.0, 2.0, (2, 2, 64, 64)).astype(np.float32)
    port = tproesmans._proesmans_level(torch.tensor(R), torch.tensor(V0), 50.0, 20, 4)
    ref = jproesmans._proesmans_level(jnp.asarray(R), jnp.asarray(V0), jnp.float32(50.0), 20, 4)
    assert np.abs(port.numpy() - np.asarray(ref)).max() <= 1e-4


def _shift_costs(small_db, n_pairs, smooth_gain):
    """VET's recentred shift cost (``max_disp=8``, templates pre-shifted by
    (1, 2)) at 4 x 4 sectors, in the port and in the JAX package, with a
    smooth start near the true motion; the mask covers one corner."""
    m = n = 128
    ii = np.clip(np.arange(m) - 1, 0, m - 1)
    jj = np.clip(np.arange(n) - 2, 0, n - 1)
    templates = np.stack([f[ii][:, jj] for f in small_db[:n_pairs]])
    targets = small_db[1:n_pairs + 1]
    if n_pairs == 1:
        templates, targets = templates[0], targets[0]
    mask = np.zeros((m, n), bool)
    mask[:6, :10] = True
    rng = np.random.default_rng(n_pairs)
    x = (np.array([[1.0], [2.0]]) + rng.normal(0.0, 0.5, (2, 16))).ravel().astype(np.float32)
    kw = {"max_disp": 8, "center_shift": (1, 2)}
    port = tvet._make_cost(torch.tensor(templates), torch.tensor(targets), torch.tensor(mask),
                           smooth_gain, (4, 4), tvet._interp_matrices(m, n, 4, 4, "cpu"), **kw)
    ref = jvet._make_cost(jnp.asarray(templates), jnp.asarray(targets), jnp.asarray(mask),
                          smooth_gain, (4, 4), jvet._interp_matrices(m, n, 4, 4), **kw)
    return port, ref, x


@pytest.mark.parametrize("n_pairs", [1, 2])
@pytest.mark.parametrize("smooth_gain", [0.0, 1e6])
def test_vet_shift_cost_against_jax(small_db, n_pairs, smooth_gain):
    """The cost and gradient of VET's card branch against JAX's: with no
    smoothness the gradient is the warp's alone."""
    port, ref, x = _shift_costs(small_db, n_pairs, smooth_gain)
    val, grad = port(torch.tensor(x))
    rval, rgrad = ref(jnp.asarray(x))
    rgrad = np.asarray(rgrad)
    assert abs(float(val) - float(rval)) <= VET_COST_RTOL * abs(float(rval))
    assert np.abs(grad.numpy() - rgrad).max() <= VET_COST_RTOL * np.abs(rgrad).max()


@pytest.mark.parametrize("n_pairs", [1, 2])
def test_vet_adam_steps_against_jax(small_db, n_pairs):
    """Five steps of the port's Adam under optax's cosine rate against
    ``optax.adam`` on the shift cost."""
    port, ref, x = _shift_costs(small_db, n_pairs, 0.0)
    px, pcost = tvet._minimize_adam([port], torch.tensor(x), n_steps=5)
    rx, rcost = jvet._minimize_adam([ref], jnp.asarray(x), n_steps=5)
    assert np.abs(px.numpy() - np.asarray(rx)).max() <= VET_ADAM_PX
    assert abs(pcost - rcost) <= VET_COST_RTOL * abs(rcost)
    assert np.abs(px.numpy() - x).max() > 100 * VET_ADAM_PX  # the steps moved x


def test_vet_options(small_db):
    frames = small_db[:2]
    dense, guesses = tvet.vet(frames, sectors=(8, 4), verbose=False, indexing="ij",
                              padding=4, intermediate_steps=True, device="cpu")
    assert tuple(dense.shape) == (2, 128, 128)
    assert [g.shape for g in guesses] == [(2, 4, 4), (2, 8, 8)]
    with pytest.raises(TypeError):
        tvet.vet(frames, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        tvet.vet(small_db[:1], device="cpu")


def test_vet_cost_function_and_morph(small_db):
    frames = small_db[:2].astype(np.float64)
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 1.0, 2 * 4 * 4)
    mask = np.zeros((128, 128), bool)
    for gradient in (False, True):
        out = tvet.vet_cost_function(x, frames, (4, 4), mask, 1e3, gradient=gradient,
                                     device="cpu")
        ref = jvet.vet_cost_function(x, frames, (4, 4), mask, 1e3, gradient=gradient)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(
        tvet.vet_cost_function_gradient(x, frames, (4, 4), mask, 1e3, device="cpu"),
        jvet.vet_cost_function_gradient(x, frames, (4, 4), mask, 1e3),
        rtol=1e-5, atol=1e-5 * 1e3)
    img = frames[0].copy()
    img[5:9, 5:9] = np.nan
    disp = np.stack([np.full((128, 128), 3.3), np.full((128, 128), -2.6)])
    out = tvet.morph(img, disp, gradient=True, device="cpu")
    ref = jvet.morph(img, disp, gradient=True)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    assert tvet.get_padding(100, 32) == jvet.get_padding(100, 32) == (14, 14)
    assert tvet.round_int(2.5) == jvet.round_int(2.5) and tvet.ceil_int(2.1) == 3


def test_lucaskanade_staged_path(small_db):
    """Another interpolation, or the sparse vectors, take the staged path."""
    frames = small_db
    xy, uv = tmotion.dense_lucaskanade(frames, dense=False, device="cpu")
    jxy, juv = jmotion.dense_lucaskanade(frames, dense=False)
    np.testing.assert_array_equal(xy, jxy)
    assert np.abs(uv - juv).max() <= PX_TOL
    out = tmotion.get_method("lk")(frames, interp_method="rbfinterp2d",
                                   interp_kwargs={"epsilon": 30.0}, device="cpu")
    ref = jmotion.get_method("lk")(frames, interp_method="rbfinterp2d",
                                   interp_kwargs={"epsilon": 30.0})
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= PX_TOL


def test_darts_spectral(small_db):
    frames = _db(128, 6)
    out = tmotion.get_method("darts")(frames, N_t=3, output_type="spectral", verbose=False,
                                      device="cpu").numpy()
    ref = np.asarray(jdarts.DARTS(frames, N_t=3, output_type="spectral", verbose=False))
    assert out.shape == ref.shape == (2, 5, 5)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    with pytest.raises(ValueError):
        tmotion.get_method("darts")(frames, N_t=5, device="cpu")


def test_proesmans_full_output(small_db, monkeypatch):
    frames = small_db[:2]
    # the Gaussian blurs agree to float32 rounding (the two libraries'
    # convolutions sum their taps in different orders) ...
    blurred = tproesmans._gauss_blur(torch.from_numpy(frames), 1.0).numpy()
    jblurred = np.stack([np.asarray(jproesmans._gauss_blur(jnp.asarray(f), 1.0)) for f in frames])
    assert np.abs(blurred - jblurred).max() <= 1e-6 * np.abs(jblurred).max()
    # ... and that rounding must not reach the solver here: the synthetic
    # flow is exactly 2 px, so at column n - 3 the update test
    # ``x + u < n - 1`` of both packages sits on its boundary, and a flip
    # there moves the flow by up to 3.4e-3 px (JAX's own solver, given
    # the port's 2.7e-6 px different start at the finest level, moves as
    # far).  So the port blurs with JAX's blur here; every other step is
    # the port's own.
    def jax_blur(img, sigma):
        flat = img.reshape(-1, *img.shape[-2:]).numpy()
        out = np.stack([np.asarray(jproesmans._gauss_blur(jnp.asarray(f), sigma)) for f in flat])
        return torch.from_numpy(out.reshape(img.shape))

    monkeypatch.setattr(tproesmans, "_gauss_blur", jax_blur)
    V, gamma = tmotion.get_method("proesmans")(frames, num_iter=20, full_output=True,
                                               filter_std=1.0, device="cpu")
    jV, jgamma = jproesmans.proesmans(frames, num_iter=20, full_output=True, filter_std=1.0)
    assert np.abs(V.numpy() - np.asarray(jV)).max() <= PX_TOL
    assert np.abs(gamma.numpy() - np.asarray(jgamma)).max() <= 1e-4


def test_proesmans_full_output_fractional_flow():
    """The port's whole pipeline, its own blur included, against JAX's on
    a 1.7 x 0.6 px flow, where no pixel sits on the update test's
    boundary that the 2 px flow above meets."""
    f = make_synthetic_sequence(n_frames=2, shape=(128, 128), velocity=(1.7, 0.6), seed=3)
    frames = (10.0 * np.log10(np.maximum(f, 0.1))).astype(np.float32)
    V, gamma = tmotion.get_method("proesmans")(frames, num_iter=20, full_output=True,
                                               filter_std=1.0, device="cpu")
    jV, jgamma = jproesmans.proesmans(frames, num_iter=20, full_output=True, filter_std=1.0)
    assert np.abs(V.numpy() - np.asarray(jV)).max() <= PX_TOL
    assert np.abs(gamma.numpy() - np.asarray(jgamma)).max() <= 1e-4


def test_farneback_options(small_db):
    frames = small_db
    out = tmotion.get_method("farneback")(frames, size_opening=3, levels=2, device="cpu")
    ref = jmotion.get_method("farneback")(frames, size_opening=3, levels=2)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= PX_TOL
    # the smoothing keeps each vector's magnitude (the JAX module's branch
    # names scipy's gaussian_filter without importing it)
    smooth = tfarneback.farneback(frames, sigma=2.0, device="cpu").numpy()
    raw = tfarneback.farneback(frames, device="cpu").numpy()
    np.testing.assert_allclose(np.hypot(*smooth), np.hypot(*raw), rtol=1e-4, atol=1e-6)


def test_constant_max_shift(small_db):
    out = tmotion.get_method("constant")(small_db[:2], max_shift=6, device="cpu")
    ref = jmotion.get_method("constant")(small_db[:2], max_shift=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_registry_names_and_errors():
    from pysteps_tpu.motion import interface as jif
    from pysteps_tpu_torch.motion import interface as tif

    assert set(tif._motion_methods) == set(jif._motion_methods)
    for name in jif._motion_methods:
        if name is not None:
            assert tmotion.get_method(name.upper()).__name__ == jmotion.get_method(name).__name__
    for name in ("brox", "clg", "BROX"):
        with pytest.raises(NotImplementedError):
            tmotion.get_method(name)
    with pytest.raises(ValueError):
        tmotion.get_method("nonexistent")
    for name in (None, "none"):
        uv = tmotion.get_method(name)(np.zeros((2, 32, 32)), device="cpu")
        assert tuple(uv.shape) == (2, 32, 32) and not uv.any()
    assert jnp.all(jmotion.get_method(None)(np.zeros((2, 32, 32))) == 0)


def _bench_db(side, n_frames):
    """The JAX bench's motion inputs (``bench.py::_make_inputs``): the
    synthetic sequence (seed 42) in dB over a -15 dB dry floor, plus
    0.1 dB of noise (seed 7)."""
    f = make_synthetic_sequence(n_frames=n_frames, shape=(side, side), velocity=(2.0, 1.0),
                                seed=42)
    db = np.where(f >= 0.1, 10.0 * np.log10(np.maximum(f, 0.1)), -15.0).astype(np.float32)
    return db + 0.1 * np.random.RandomState(7).randn(*db.shape).astype(np.float32)


def bench_truth(side=512):
    """Each solver of the JAX bench (its frame counts and defaults) on the
    bench's inputs, in the JAX package and in the port on the CPU, through
    both branches where there are two (exact gather, and the shift warp
    the card takes): one JSON line each with the relative RMSE against
    (2, 1) 20 px from the borders and the largest difference of the two
    flows."""
    import json
    import time

    frames = {"lucaskanade": 3, "vet": 3, "proesmans": 2, "darts": 9, "farneback": 3}
    for method, n_frames in frames.items():
        x = _bench_db(side, n_frames)
        for shift in ((False, True) if method in ("vet", "proesmans", "farneback") else (False,)):
            t0 = time.time()
            if method == "proesmans":
                ref = jproesmans._proesmans_full(jnp.asarray(x[-2]), jnp.asarray(x[-1]),
                                                 jnp.float32(50.0), 6, 100, 0.0, shift, False)
                port = tproesmans._proesmans_full(torch.tensor(x[-2]), torch.tensor(x[-1]), 50.0,
                                                  6, 100, 0.0, shift, False)
            elif method == "farneback":
                ref = jfarneback._farneback_full(jnp.asarray(x[-2]), jnp.asarray(x[-1]), 4, 5, 7,
                                                 1.5, 32, shift)
                port = tfarneback._farneback_full(torch.tensor(x[-2]), torch.tensor(x[-1]), 4, 5,
                                                  7, 1.5, 32, shift)
            else:
                kw = {"verbose": False} if method in ("vet", "darts") else {}
                if method == "vet":
                    kw["max_disp"] = "shift" if shift else None
                ref = jmotion.get_method(method)(x, **kw)
                port = tmotion.get_method(method)(x, device="cpu", **kw)
            ref, port = np.asarray(ref), port.numpy()
            print(json.dumps({"method": method, "side": side, "frames": n_frames,
                              "branch": "shift" if shift else "exact",
                              "jax_rel_rmse": _rel_rmse(ref), "port_rel_rmse": _rel_rmse(port),
                              "max_abs_diff_px": float(np.abs(port - ref).max()),
                              "rms_diff_px": _rms(port, ref), "s": time.time() - t0}),
                  flush=True)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_motion.py [side]
    bench_truth(int(sys.argv[1]) if len(sys.argv) > 1 else 512)
