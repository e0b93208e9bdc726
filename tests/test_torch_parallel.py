"""The port's ``parallel/`` (mesh, halo, dist_fft, sharded_steps), STEPS'
``mesh=`` and ``verification/parallel`` on ``gloo`` against the JAX
package's, which runs on its 8 virtual CPU devices.

One process group of 4 spawned ranks (``tests/torch_parallel_workers.py``,
which imports no JAX) runs every multi-rank check once for the module;
each test below holds one of its results against JAX or the port's
single-process functions:

- the mesh's axes and each rank's member block;
- ``sharded_warp`` on 4 row shards against ``warp_shifted`` (the port's
  and JAX's) within 1e-5;
- ``rfft2_local`` / ``irfft2_local`` on 2 and 4 shards, including widths
  whose n//2+1 columns need padding, against ``np.fft.rfft2`` and
  ``jnp.fft.rfft2`` (1e-3, tests/test_parallel.py:292), the round trip
  within 1e-5, the Parseval weights and column masks exactly;
- the sharded det-cat, CRPS and FSS states against the serial chains
  (int64 counts exact, CSI rtol 1e-6, CRPS and FSS rtol 1e-5, as
  tests/test_parallel.py:244-290);
- ``_prepare_pwl_target`` exactly, and both psum matchers on 4 row shards
  against JAX's under a ``shard_map`` on 4 devices, within 1e-4 x span:
  JAX evaluates the map as two float32 sums of 128 terms (a 0/1 matrix
  times the coefficient differences), the port reads its segment's two
  coefficients, and those sums' rounding reaches 8.9e-6 x span (JAX
  compiled, 1.6e-5 op by op);
- ``_dilated_mask_halo`` on 4 row shards, its halo from the neighbours
  and gathered whole, equal to JAX's under a ``shard_map``;
- ``sharded_steps.forecast`` on 2 ens x 2 y against 1 x 1, with and without
  BPS: equal NaN sets, finite inside the border, atol 0.01
  (tests/test_parallel.py:327-390);
- STEPS' ``mesh=`` on 2 and 4 ens ranks equal to the port's unsharded
  forecast bit for bit on one thread, and within atol 3e-2 with equal NaN
  sets of the unsharded forecast on this process's threads
  (tests/test_parallel.py:46-48: other sum orders move a few pixels
  through the CDF match);
- ``sharded_steps`` 1 x 1 against JAX's 1 x 1 in law by the
  ``MODEL_PARITY.json`` recipe (CRPS and spread/error over 6 leads, seeds
  11 and 22, within 10%);
- ``sharded_steps`` 1 x 1 against JAX's 1 x 1 value by value on JAX's
  draws handed in (each member's white spectra and, with BPS, the Laplace
  draws), on a gloo group of this process alone: equal NaN sets, every
  pixel within 1e-4 of the span and the mean within 5e-6 of it.  The
  init, the normalization of the noise, the AR step, the recomposition,
  the mask and its renormalization, the velocity sampling and the warp
  are then JAX's up to float32 rounding; the PWL match hands that
  rounding on (6.3e-5 of the span at most over 3 leads, 2e-6 on
  average), where a noise std 1% too large moves pixels by 3.5e-3 of it.
  (A constant factor on the mask's renormalization scales each member's
  field above its minimum by one number, which the rank-based match
  cannot see, here as in JAX.)
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402

from pysteps_tpu.noise import fftgenerators as jfft  # noqa: E402
from pysteps_tpu.noise import motion as jmotion  # noqa: E402
from pysteps_tpu.ops.warp import warp_shifted as jwarp_shifted  # noqa: E402
from pysteps_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from pysteps_tpu.parallel import sharded_steps as jss  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402
from pysteps_tpu_torch.ops.warp import warp_shifted  # noqa: E402
from pysteps_tpu_torch.parallel import make_mesh  # noqa: E402
from pysteps_tpu_torch.parallel import sharded_steps as tss  # noqa: E402
from pysteps_tpu_torch.verification import (  # noqa: E402
    detcatscores,
    probscores,
    spatialscores,
)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every rank's results of ``workers.parallel_checks``."""
    return workers.run_group(workers.parallel_checks, tmp_path_factory.mktemp("pg"))


def test_mesh_axes_and_member_blocks(group):
    arr = np.arange(8 * 4 * 4, dtype=np.float32).reshape(8, 4, 4)
    coords = set()
    for res in group:
        assert tuple(res["mesh_shape"]) == (2, 2, 1)
        assert tuple(res["mesh_names"]) == ("ens", "y", "x")
        e = int(res["mesh_coord"][0])
        coords.add(tuple(res["mesh_coord"]))
        np.testing.assert_array_equal(res["ens_block"], arr[4 * e : 4 * e + 4])
    assert coords == {(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)}


def test_sharded_warp_against_warp_shifted(group):
    field, disp, max_disp = workers.warp_inputs()
    port = warp_shifted(torch.as_tensor(field), torch.as_tensor(disp), max_disp, cval=0.0)
    jax_ref = np.asarray(jwarp_shifted(jnp.asarray(field), jnp.asarray(disp), max_disp, cval=0.0))
    for res in group:
        np.testing.assert_allclose(res["sharded_warp"], port.numpy(), atol=1e-5)
        np.testing.assert_allclose(res["sharded_warp"], jax_ref, atol=1e-5)


@pytest.mark.parametrize("case", list(workers.FFT_CASES))
def test_rfft2_local_against_fft(group, case):
    y, n = workers.FFT_CASES[case]
    f = workers.fft_field(n)
    c = n // 2 + 1
    res = group[0]
    spec = res[f"fft_{case}_spec"]
    assert spec.shape == (64, -(-c // y) * y)
    np.testing.assert_allclose(spec[:, :c], np.fft.rfft2(f), atol=1e-3)
    np.testing.assert_allclose(spec[:, :c], np.asarray(jnp.fft.rfft2(f)), atol=1e-3)
    assert not spec[:, c:].any()
    np.testing.assert_allclose(res[f"fft_{case}_back"], f, atol=1e-5)
    cols = np.arange(spec.shape[1])
    herm = np.where((cols == 0) | ((n % 2 == 0) & (cols == c - 1)), 1.0, 2.0) * (cols < c)
    np.testing.assert_array_equal(res[f"fft_{case}_weight"], herm)
    np.testing.assert_array_equal(res[f"fft_{case}_mask"], cols < c)


def test_distributed_verification_against_serial(group):
    pred, obs, ens = workers.verification_inputs()
    serial = detcatscores.det_cat_fct_init(1.0)
    detcatscores.det_cat_fct_accum(serial, pred[:4], obs[:4], device="cpu")
    other = detcatscores.det_cat_fct_init(1.0)
    detcatscores.det_cat_fct_accum(other, pred[4:], obs[4:], device="cpu")
    serial = detcatscores.det_cat_fct_merge(serial, other)
    serial_c = probscores.CRPS_init()
    serial_f = spatialscores.fss_init(1.0, 4)
    for i in range(len(pred)):
        probscores.CRPS_accum(serial_c, ens[i], obs[i], device="cpu")
        spatialscores.fss_accum(serial_f, pred[i], obs[i], device="cpu")
    for res in group:
        assert str(res["detcat_dtype"]) == "torch.int64"
        for k in ("hits", "false_alarms", "misses", "correct_negatives"):
            assert int(res[f"detcat_{k}"]) == int(serial[k])
        np.testing.assert_allclose(
            res["detcat_csi"], float(detcatscores.det_cat_fct_compute(serial, "CSI")),
            rtol=1e-6)
        s, n = res["crps_state"]
        np.testing.assert_allclose(
            probscores.CRPS_compute({"CRPS_sum": s, "n": n}),
            probscores.CRPS_compute(serial_c), rtol=1e-5)
        so, fo, sf = res["fss_state"]
        np.testing.assert_allclose(
            spatialscores.fss_compute({"sum_obs_sq": so, "sum_fct_obs": fo, "sum_fct_sq": sf}),
            spatialscores.fss_compute(serial_f), rtol=1e-5)


def test_prepare_pwl_target_against_jax():
    _, target = workers.match_inputs()
    port = tss._prepare_pwl_target(torch.as_tensor(target))
    ref = jss._prepare_pwl_target(target)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))


def _jax_match(which, fields, target):
    """JAX's psum matcher of each member on 4 row shards."""
    mesh = jmake_mesh(ens=1, y=4)
    tstate = jss._prepare_pwl_target(target)
    size = float(fields[0].size)
    ranked, zvalue, c_t, tlo, tscale, n_wet = tstate

    def member(x):
        if which == "psum":
            return jss._match_cdf_psum(x, tstate, size, "y")
        return jss._match_cdf_psum_binned(x, zvalue, c_t, tlo, tscale, n_wet,
                                          ranked[-1] - 1.0, size, "y")

    fn = jax.jit(jax.shard_map(jax.vmap(member), mesh=mesh, in_specs=P(None, "y", None),
                               out_specs=P(None, "y", None)))
    return np.asarray(fn(jnp.asarray(fields)))


@pytest.mark.parametrize("which", ["psum", "binned"])
def test_psum_matchers_against_jax(group, which):
    fields, target = workers.match_inputs()
    ref = _jax_match(which, fields, target)
    span = float(target.max() - target.min())
    for res in group:
        np.testing.assert_allclose(res[f"match_{which}"], ref, atol=1e-4 * span)
    # without a mesh the matcher sees the whole grid as one block: the
    # same ranks and maps, bit for bit
    if which == "psum":
        tstate = tss._prepare_pwl_target(torch.as_tensor(target))
        one = tss._match_cdf_psum(torch.as_tensor(fields), tstate, float(fields[0].size), None)
        np.testing.assert_array_equal(one.numpy(), group[0]["match_psum"])


@pytest.mark.parametrize("kr,r", workers.MASK_CASES)
def test_dilated_mask_halo_against_jax(group, kr, r):
    fields, _ = workers.match_inputs()
    def local(x):
        return jax.vmap(lambda f: jss._dilated_mask_halo(f, workers.MASK_THR, kr, r, "y"))(x)

    fn = jax.jit(jax.shard_map(local, mesh=jmake_mesh(ens=1, y=4), in_specs=P(None, "y", None),
                               out_specs=P(None, "y", None)))
    ref = np.asarray(fn(jnp.asarray(fields)))
    # dry rows, a rim and the wet area: the case reaches every part of the mask
    assert ref.min() == 0.0 and ref.max() == 1.0 and ((ref > 0) & (ref < 1)).any()
    for res in group:
        np.testing.assert_array_equal(res[f"mask_{kr}_{r}"], ref)


@pytest.mark.parametrize("vp", [None, "bps"])
def test_sharded_steps_layouts_agree(group, vp):
    multi = group[0][f"ss_2x2_{vp}"]
    single = group[0 if vp is None else 1][f"ss_1x1_{vp}"]
    assert multi.shape == (4, 3, 128, 128)
    for res in group[1:]:
        np.testing.assert_array_equal(res[f"ss_2x2_{vp}"], multi)
    assert np.array_equal(np.isnan(multi), np.isnan(single))
    b = 3 * 2 + 2
    assert np.isfinite(multi[:, :, b:-b, b:-b]).all()
    np.testing.assert_allclose(np.nan_to_num(multi), np.nan_to_num(single), atol=0.01)
    if vp == "bps":
        assert np.abs(multi - group[0]["ss_2x2_None"]).max() > 0.1


@pytest.mark.parametrize("case", list(workers.STEPS_CASES))
def test_steps_mesh_equals_unsharded(group, case):
    ens_n, kw = workers.STEPS_CASES[case]
    sharded = group[0][f"steps_{case}"]
    plain = group[ens_n % workers.WORLD][f"steps_{case}_plain"]
    assert sharded.shape == (kw.get("n_ens_members", 8), 2, 64, 64)
    np.testing.assert_array_equal(sharded, plain)
    # the parent's run, with its own thread count, sums in other orders;
    # the CDF match moves a few pixels (tests/test_parallel.py:46-48)
    db, vel = workers.steps_inputs()
    here = tnowcasts.get_method("steps")(db, vel, 2, device="cpu",
                                         **dict(workers.STEPS_KW, **kw)).numpy()
    assert np.array_equal(np.isnan(here), np.isnan(sharded))
    np.testing.assert_allclose(np.nan_to_num(sharded), np.nan_to_num(here), atol=3e-2)


def test_sharded_steps_law_against_jax(group):
    db, vel, truth = workers.law_inputs()
    j, t = [], []
    for i, seed in enumerate(workers.LAW_SEEDS):
        ref = jss.forecast(db, vel, 6, jmake_mesh(ens=1, y=1), seed=seed, **workers.LAW_KW)
        j.append(workers.law_scores(np.asarray(ref), truth))
        out = group[2 + i][f"law_{seed}"]
        assert out.shape == (16, 6, 128, 128) and np.isfinite(out).all()
        t.append(workers.law_scores(out, truth))
    (c_j, r_j), (c_t, r_t) = np.mean(j, axis=0), np.mean(t, axis=0)
    assert abs(c_t - c_j) / c_j <= 0.1, (c_t, c_j)
    assert abs(r_t - r_j) / r_j <= 0.1, (r_t, r_j)


def _jax_draws(E, shape, T, seed):
    """JAX's sharded forecast's draws in the port's order of calls: each
    lead's white spectrum of every member (``sharded_steps.py``'s member
    keys, split once a lead), then the BPS parallel and perpendicular
    Laplace draws of all members."""
    keys = [jax.random.fold_in(jax.random.PRNGKey(seed), j) for j in range(E)]
    white = []
    for _ in range(T):
        for j in range(E):
            keys[j], k = jax.random.split(keys[j])
            white.append(torch.as_tensor(np.array(jfft._spectral_white(k, shape)))[None])
    vkeys = jax.random.split(jax.random.PRNGKey(seed + 7), 2 * E)
    laplace = [torch.as_tensor(np.asarray(jax.vmap(jmotion._laplace)(k), np.float32))
               for k in (vkeys[:E], vkeys[E:])]
    return white, laplace


@pytest.mark.parametrize("vp", [None, "bps"])
def test_sharded_steps_against_jax_on_handed_draws(monkeypatch, tmp_path, vp):
    db, vel = workers.ss_inputs()
    kw = workers.SS_KW
    T, E = 3, kw["n_ens_members"]
    ref = np.asarray(jss.forecast(db, vel, T, jmake_mesh(ens=1, y=1), vel_pert_method=vp,
                                  **kw), np.float64)
    white, laplace = _jax_draws(E, db.shape[1:], T, kw["seed"])
    white, laplace = iter(white), iter(laplace)
    monkeypatch.setattr(tss, "_spectral_white", lambda gen, shape, batch: next(white))
    monkeypatch.setattr(tss, "_laplace", lambda gen, shape: next(laplace))
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                                         world_size=1)
    try:
        mesh = make_mesh(ens=1, device_type="cpu")
        out = tss.forecast(db, vel, T, mesh, vel_pert_method=vp, **kw).numpy()
    finally:
        torch.distributed.destroy_process_group()
    # every draw was taken, the Laplace draws with BPS only
    assert next(white, None) is None and len(list(laplace)) == (0 if vp else 2)
    out = out.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    span = np.nanmax(ref) - np.nanmin(ref)
    diff = np.nan_to_num(np.abs(out - ref)) / span
    assert diff.max() <= 1e-4 and diff.mean() <= 5e-6, (diff.max(), diff.mean())


def test_cuda_mesh_needs_a_card(monkeypatch):
    from pysteps_tpu_torch.parallel import make_mesh, make_mesh_multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_mesh, make_mesh_multihost):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
