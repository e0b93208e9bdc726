"""The port's spatially sharded STEPS blending
(``parallel/sharded_blending.py``) and the ``mesh=`` of blending, the PCA
fit, both EnKFs and VET on ``gloo``, against the unsharded port and the JAX
package, which runs on its 8 virtual CPU devices.

One process group of 4 spawned ranks (``tests/torch_parallel_workers.py``,
which imports no JAX, ``blending_checks``) runs every multi-rank check once
for the module; each test below holds one of its results:

- blending on 2 ens x 2 y with ``probmatching_method="mean"`` against the
  unsharded forecast, and on 4 ens x 1 (the member blocks) with the
  default CDF match and resampled target, atol 5e-3
  (tests/test_parallel.py:72-141); the blocks equal the unsharded forecast
  of one rank's thread bit for bit;
- shard-count invariance: the default configuration with BPS on 1 x 2
  against 2 x 2, and a 32-row grid on 1 x 2 against 1 x 4 (8-row blocks,
  whose halo passes a block, so the exchange gathers), atol 5e-3
  (tests/test_parallel.py:144-219);
- the sharded noise normalization on 4 row shards (Parseval moments, the
  DC fix, the distributed inverse FFTs) against JAX's under a
  ``shard_map``, and the resampled target's host tables against JAX's;
- the sharded PCA fit on 4 ranks (over "y", and padded over "ens")
  against JAX's;
- VET's sharded cost against JAX's on 4 devices, and VET on 4 row shards
  against unsharded VET within 0.1 px (tests/test_parallel.py:222-241),
  every rank's flow bit-equal;
- the masked EnKF and the PCA EnKF with a mesh against unsharded;
- the spatial route's refusals (external nowcast, chunked loop, rows or
  members that do not divide).

The sharded scan against JAX's on JAX's draws handed in runs on a gloo
group of this process alone.
"""

import inspect
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

from pysteps_tpu.blending import steps as jsteps  # noqa: E402
from pysteps_tpu.motion import vet as jvet  # noqa: E402
from pysteps_tpu.noise import fftgenerators as jfft  # noqa: E402
from pysteps_tpu.parallel import dist_fft as jdist_fft  # noqa: E402
from pysteps_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from pysteps_tpu.parallel import sharded_blending as jsb  # noqa: E402
from pysteps_tpu.utils import pca as jpca  # noqa: E402
from pysteps_tpu_torch import blending as tblending  # noqa: E402
from pysteps_tpu_torch.blending import pca_ens_kalman_filter as tpca_enkf  # noqa: E402
from pysteps_tpu_torch.blending import steps as tsteps  # noqa: E402
from pysteps_tpu_torch.motion import vet as tvet  # noqa: E402
from pysteps_tpu_torch.parallel import make_mesh  # noqa: E402
from pysteps_tpu_torch.parallel import sharded_blending as tsb  # noqa: E402
from pysteps_tpu_torch.utils import pca as tpca  # noqa: E402

ATOL = 5e-3  # tests/test_parallel.py:103, :141, :179, :219


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every rank's results of ``workers.blending_checks``."""
    return workers.run_group(workers.blending_checks, tmp_path_factory.mktemp("pg"))


@pytest.fixture(scope="module")
def skill_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("skill"))


def _ranks(group, name):
    """The ranks of ``name``'s mesh and their (equal) results."""
    outs = [res[name] for res in group if name in res]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    return outs


def _allclose(a, b, atol=ATOL):
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol)


@pytest.mark.parametrize("case", ["y_mean", "ens4"])
def test_sharded_blending_against_unsharded(group, skill_dir, case):
    outs = _ranks(group, f"blend_{case}")
    (ens, y), _, _, kw = workers.BLEND_CASES[case]
    assert len(outs) == ens * y
    assert outs[0].shape == (kw["n_ens_members"], 2, 64, 64)
    # on one thread, as the ranks: the member blocks are the unsharded
    # forecast bit for bit; the row blocks sum the moments in other orders
    plain = group[workers.BLEND_PLAIN[case]][f"blend_{case}_plain"]
    if y == 1:
        np.testing.assert_array_equal(outs[0], plain)
    else:
        _allclose(outs[0], plain, atol=1e-4)
    here = workers.blend_case(case, skill_dir).numpy()
    _allclose(outs[0], here)


@pytest.mark.parametrize("pair", [("inv_1x2", "inv_2x2"), ("halo_1x2", "halo_1x4")])
def test_sharded_blending_shard_count_invariance(group, pair):
    small, large = (_ranks(group, f"blend_{name}")[0] for name in pair)
    assert np.isfinite(large).all() and np.isfinite(small).all()
    _allclose(small, large)
    if pair[0].startswith("halo"):
        # 8-row blocks: the halo passes a block, so the exchange gathers
        assert int(group[0]["halo_1x4_halo"]) > 32 // 4


def test_spatial_route_refuses_what_jax_refuses(group):
    for res in group:
        for name in ("err_members", "err_rows", "err_external", "err_chunked"):
            assert bool(res[name]), name


def _jax_noise(white, filt, w2d, nsc):
    """JAX's sharded noise normalization (sharded_blending.py:332-361) of
    each member on 4 row shards."""
    m, n = 64, 64
    c, c_pad = 33, 36
    size_f = float(m * n)

    def padc(a):
        return jnp.pad(jnp.asarray(a), [(0, 0)] * (a.ndim - 1) + [(0, c_pad - c)])

    cols = jnp.arange(c_pad)
    herm = jnp.where((cols == 0) | (cols == c - 1), 1.0, 2.0) * (cols < c)

    def run(white_l, filt_l, w2d_l, herm_l):
        c_loc = filt_l.shape[-1]
        col0 = jax.lax.axis_index("y") * c_loc

        def member(w):
            lv = w[None] * filt_l[None] * w2d_l
            pw = jnp.real(lv) ** 2 + jnp.imag(lv) ** 2
            s2 = jax.lax.psum(jnp.sum(pw * herm_l[None, None, :], axis=(1, 2)), "y")
            dc = jnp.where(col0 == 0, jnp.real(lv[:, 0, 0]), jnp.zeros(lv.shape[0]))
            mu = jax.lax.psum(dc, "y") / size_f
            sd = jnp.sqrt(jnp.maximum(s2 / size_f**2 - mu**2, 0.0))
            first = ((col0 == 0)
                     & (jax.lax.broadcasted_iota(jnp.int32, lv.shape, 1) == 0)
                     & (jax.lax.broadcasted_iota(jnp.int32, lv.shape, 2) == 0))
            dc_fix = jnp.where(first, (mu * size_f)[:, None, None].astype(lv.dtype),
                               jnp.zeros_like(lv))
            lv = (lv - dc_fix) * (nsc / jnp.maximum(sd, 1e-12))[:, None, None]
            levels = jax.vmap(lambda f: jdist_fft.irfft2_local(f, (m, n), "y"))(lv)
            return levels, mu, sd

        return jax.vmap(member)(white_l)

    fn = jax.jit(jax.shard_map(
        run, mesh=jmake_mesh(ens=1, y=4),
        in_specs=(P(None, None, "y"), P(None, "y"), P(None, None, "y"), P("y")),
        out_specs=(P(None, None, "y", None), P(), P()), check_vma=False))
    return [np.asarray(x) for x in fn(padc(white), padc(filt), padc(w2d), herm)]


def test_noise_normalization_against_jax(group):
    white, filt, w2d, nsc = workers.noise_inputs()
    levels, mu, sd = _jax_noise(white, filt, w2d, nsc)
    for res in group:
        np.testing.assert_allclose(res["noise_mu"], mu, rtol=1e-6, atol=1e-6 * np.abs(mu).max())
        np.testing.assert_allclose(res["noise_sd"], sd, rtol=1e-6)
        np.testing.assert_allclose(res["noise_levels"], levels,
                                   atol=1e-6 * np.abs(levels).max())


def _aligned(vt, ref):
    """``vt``'s rows with the signs of ``ref``'s."""
    sign = np.sign(np.sum(vt * ref, axis=1, keepdims=True))
    return vt * np.where(sign == 0, 1.0, sign)


@pytest.mark.parametrize("case", list(workers.PCA_CASES))
def test_sharded_pca_fit_against_jax(group, case):
    """Every component with variance agrees up to its sign within 1e-4; the
    last component of a centred ensemble has none (its eigenvalue is
    rounding), so it is noise in both packages and left out."""
    (ens, y), n_feat = workers.PCA_CASES[case]
    Xc = workers.pca_inputs(n_feat)
    vt_j, var_j = (np.asarray(a) for a in jpca._fit_pca_sharded(
        jnp.asarray(Xc), jmake_mesh(ens=ens, y=y)))
    # the port's unsharded SVD fit, for the same components
    _, par = tpca.pca_transform(torch.as_tensor(Xc), get_params=True, device="cpu")
    vt_svd = par["principal_components"].numpy()
    keep = var_j > 1e-6 * var_j.max()
    assert keep.sum() == Xc.shape[0] - 1
    for res in group:
        vt, var = res[f"pca_{case}_vt"], res[f"pca_{case}_var"]
        assert vt.shape == (Xc.shape[0], n_feat)
        np.testing.assert_allclose(var, var_j, rtol=1e-5, atol=1e-5 * var_j.max())
        np.testing.assert_allclose(_aligned(vt, vt_j)[keep], vt_j[keep], atol=1e-4)
        np.testing.assert_allclose(_aligned(vt, vt_svd)[keep], vt_svd[keep], atol=1e-4)


def test_sharded_vet_cost_against_jax(group):
    tmpl, trg, mask, x = workers.vet_cost_inputs()
    si, sj = workers.VET_SECTORS
    cost = jvet._make_cost_sharded(jnp.asarray(tmpl), jnp.asarray(trg), jnp.asarray(mask),
                                   workers.VET_SMOOTH, (si, sj),
                                   jvet._interp_matrices(64, 64, si, sj), jmake_mesh(ens=1, y=4))
    value, grad = (np.asarray(a, np.float64) for a in cost(jnp.asarray(x)))
    for res in group:
        np.testing.assert_allclose(float(res["vet_cost_value"]), value, rtol=1e-5)
        np.testing.assert_allclose(res["vet_cost_grad"], grad, rtol=1e-5,
                                   atol=1e-5 * np.abs(grad).max())


def test_sharded_vet_against_unsharded(group):
    flows = _ranks(group, "vet_flow")  # bit-equal on every rank
    assert len(flows) == 4 and flows[0].shape == (2, 64, 64)
    plain = tvet.vet(workers.vet_inputs(), device="cpu", **workers.VET_KW).numpy()
    np.testing.assert_allclose(flows[0], plain, atol=0.1)


def test_masked_enkf_with_a_mesh_against_unsharded(group):
    """``MaskedEnKF.correct_step`` with the Gram fit on 4 ranks against the
    SVD fit, within tests/test_torch_enkf.py's 1e-4 of the largest value
    (the case of test_masked_enkf_correct_step, whose gain system is not
    singular)."""
    plain, prob = workers.masked_enkf_steps(None)
    for res in _ranks(group, "masked_enkf"):
        scale = np.abs(plain).max()
        assert np.abs(res - plain).max() <= 1e-4 * scale
    for res in group:
        assert abs(float(res["masked_enkf_prob"][0]) - float(prob[0])) <= 1e-5


def test_pca_enkf_with_a_mesh_against_unsharded(group):
    """The combination loop runs replicated: the mesh leaves it as it is."""
    out = _ranks(group, "pca_enkf")[0]
    np.testing.assert_array_equal(out, group[0]["pca_enkf_plain"])
    obs, nwp_ens, velocity = workers.enkf_inputs()
    here = tpca_enkf.forecast(obs, None, nwp_ens, None, velocity, 3, device="cpu",
                              **workers.ENKF_KW).numpy()
    assert np.array_equal(np.isnan(out), np.isnan(here))
    span = np.nanmax(here) - np.nanmin(here)
    diff = np.nan_to_num(np.abs(out - here)) / span
    assert np.mean(diff <= 1e-4) >= 0.999 and diff.mean() <= 1e-6 and diff.max() <= 1e-2


def _capture(monkeypatch):
    """Record the arguments of JAX's ``blending_scan_sharded`` and the host
    tables of its resampled target (the arrays it hands ``jnp.asarray``)."""
    rec, tables = {}, []
    orig = jsb.blending_scan_sharded
    sig = inspect.signature(orig)

    def recording(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        rec.update(bound.arguments)
        return orig(*args, **kwargs)

    class Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def asarray(a, *args, **kwargs):
            if isinstance(a, np.ndarray):
                tables.append(a.copy())
            return jnp.asarray(a, *args, **kwargs)

    monkeypatch.setattr(jsb, "blending_scan_sharded", recording)
    monkeypatch.setattr(jsb, "jnp", Jnp())
    return rec, tables


def _jax_draws(rec, T):
    """JAX's sharded blend's draws in the port's order of calls: each
    lead's white half-planes of every member (member keys
    ``fold_in(PRNGKey(seed), i)``, split once a lead), then, with a
    resampled target, every member's picks ``bernoulli(fold_in(key, t))``."""
    E = rec["E"]
    m, n = rec["noise_filt_shape"]
    keys = list(np.asarray(rec["member_keys"]))
    w_t = np.asarray(rec["weights_t"])
    model = np.asarray(rec["member_model"])
    resample = rec["resample_distribution"] and rec["probmatching"] == "cdf"
    white, picks = [], []
    for t in range(T):
        w_lead, p_lead = [], []
        for j in range(E):
            keys[j], k_noise = jax.random.split(jnp.asarray(keys[j]))
            w_lead.append(np.asarray(jfft._spectral_white(k_noise, (m, n))))
            if resample:
                w = jnp.asarray(w_t[t, model[j]])
                p_radar = jnp.sum(w[0]) / jnp.maximum(jnp.sum(w[0]) + jnp.sum(w[1]), 1e-12)
                p_lead.append(np.asarray(jax.random.bernoulli(
                    jax.random.fold_in(keys[j], t), p_radar, (m * n,))))
        white.append(torch.as_tensor(np.stack(w_lead)))
        if resample:
            picks.append(torch.as_tensor(np.stack(p_lead)))
    return white, picks


# (probmatching_method, vel_pert_method): "mean" and the resampled CDF
# target, with and without BPS
HANDED = {"mean": ("mean", None), "cdf": ("cdf", None), "cdf_bps": ("cdf", "bps")}


@pytest.mark.parametrize("case", list(HANDED))
def test_sharded_scan_against_jax_on_handed_draws(monkeypatch, tmp_path, skill_dir, case):
    """JAX's ``blending_scan_sharded`` (through its forecast on a 1 x 2
    mesh) against the port's on a 1 x 1 gloo mesh, on JAX's init carried
    over and JAX's draws handed in: equal NaN sets, every pixel within
    1e-4 of the span, the mean within 5e-6 of it."""
    pm, vp = HANDED[case]
    args = workers.blend_inputs(9)
    kw = dict(workers.BLEND_KW, n_ens_members=4, seed=3, probmatching_method=pm,
              vel_pert_method=vp)
    rec, tables = _capture(monkeypatch)
    ref = np.asarray(jsteps.forecast(*args, 2, 5, mesh=jmake_mesh(ens=1, y=2),
                                     outdir_path_skill=skill_dir, **kw), np.float64)
    T = rec["int_steps"]
    arrays = {k: np.asarray(v) for k, v in rec.items()
              if isinstance(v, (np.ndarray, jax.Array)) and k != "member_keys"}
    params, state = tsteps.params_from_numpy(arrays, "cpu", seed=0)
    white, picks = _jax_draws(rec, T)
    white_it, picks_it = iter(white), iter(picks)
    monkeypatch.setattr(tsb, "_fft_noise_draw", lambda gen, shape, batch, dom, full: next(white_it))
    monkeypatch.setattr(tsb, "_bernoulli", lambda gen, p, shape: next(picks_it))
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                                         world_size=1)
    try:
        mesh = make_mesh(ens=1, device_type="cpu")
        out = tsb.blending_scan_sharded(
            params, state, T, mesh, mask_method=rec["mask_method"],
            probmatching_method=rec["probmatching"],
            resample_distribution=rec["resample_distribution"], mask_rim=rec["mask_rim"],
            struct_radius=rec["struct_radius"], precip_thr=float(rec["precip_thr"]),
            vel_pert=rec["vel_pert"], p_par=rec["p_par"], p_perp=rec["p_perp"],
            vsf=float(rec["vsf"]), timestep_min=float(rec["timestep_min"]),
            use_noise=rec["use_noise"], vmax_bound=rec["vmax_bound"]).numpy()
    finally:
        torch.distributed.destroy_process_group()
    assert next(white_it, None) is None and next(picks_it, None) is None
    if pm == "cdf":
        # JAX's host tables of the resampled target: the sorts, the rank
        # indices, the bin grid's origin and scale
        port = tsb._resample_tables(arrays["precip_last"], arrays["nwp_fields"],
                                    float(arrays["precip_min"]))
        assert len(tables) == 6
        for p, j in zip(port, tables):
            np.testing.assert_array_equal(np.asarray(p, j.dtype), j)
    out = out.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    span = np.nanmax(ref) - np.nanmin(ref)
    diff = np.nan_to_num(np.abs(out - ref)) / span
    assert diff.max() <= 1e-4 and diff.mean() <= 5e-6, (diff.max(), diff.mean())


def test_binned_targets_count_the_mixed_target():
    """Each member's binned CDF from the suffix sums is the histogram of its
    mixed target's bins, summed up to each bin."""
    rng = np.random.RandomState(4)
    last = rng.gamma(1.0, 3.0, (16, 16)).astype(np.float32)
    nwp = rng.gamma(1.0, 3.0, (2, 1, 16, 16)).astype(np.float32)
    rsort, nsort, idx_r, idx_n, tlo, tscale = tsb._resample_tables(last, nwp, 0.0)
    pick = rng.rand(3, 256) < 0.4
    zv, trg_max, n_wet, c_mix = tsb._binned_targets(
        torch.as_tensor(pick), torch.as_tensor(rsort.copy()),
        torch.as_tensor(np.repeat(nsort[1], 3, axis=0)),
        torch.as_tensor(np.repeat(idx_r[1], 3, axis=0)),
        torch.as_tensor(np.repeat(idx_n[1], 3, axis=0)))
    for j in range(3):
        mixed = np.where(pick[j], rsort, nsort[1, 0])
        bins = np.clip(np.round((mixed - tlo[1, 0]) * tscale[1, 0]), 0, tsb.B_T - 1)
        counts = np.cumsum(np.bincount(bins.astype(np.int64), minlength=tsb.B_T))
        np.testing.assert_array_equal(c_mix[j].numpy(), counts)
        assert float(zv[j]) == mixed.min() and float(trg_max[j]) == mixed.max()
        assert int(n_wet[j]) == int((mixed > mixed.min()).sum())


def test_mesh_must_be_a_device_mesh(skill_dir):
    """``mesh=object()`` raises TypeError on all five entry points."""
    db, nwp, vel, vel_m = workers.blend_inputs(2)
    obs, nwp_ens, velocity = workers.enkf_inputs()
    bg, ob, Cfg, kw = workers.masked_enkf_inputs()
    from pysteps_tpu_torch.blending.ens_kalman_filter_methods import MaskedEnKF

    calls = [
        lambda: tblending.get_method("steps")(db, nwp, vel, vel_m, 2, 5, mesh=object(),
                                              device="cpu", outdir_path_skill=skill_dir,
                                              **workers.BLEND_KW),
        lambda: tpca.pca_transform(np.ones((4, 10), np.float32), mesh=object(), device="cpu"),
        lambda: MaskedEnKF(Cfg(), type("P", (), {"combination_kwargs": {"mesh": object()}})()),
        lambda: tpca_enkf.forecast(obs, None, nwp_ens, None, velocity, 3, device="cpu",
                                   mesh=object(), **workers.ENKF_KW),
        lambda: tvet.vet(workers.vet_inputs(), mesh=object(), device="cpu"),
    ]
    for call in calls:
        with pytest.raises(TypeError):
            call()


def test_cuda_mesh_needs_a_card(monkeypatch, skill_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(ens=1, y=2)
    db, nwp, vel, vel_m = workers.blend_inputs(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tblending.get_method("steps")(db, nwp, vel, vel_m, 2, 5, outdir_path_skill=skill_dir,
                                      **workers.BLEND_KW)
