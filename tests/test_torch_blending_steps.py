"""STEPS blending in the PyTorch port against the JAX package on the CPU
(``pysteps_tpu_torch/blending/steps.py`` against
``pysteps_tpu/blending/steps.py``), 64^2, 3 members, 3 leads, 6 levels.

- ``_blending_scan`` on JAX's init carried over by ``params_from_numpy``,
  on both branches: the exact gather (the CPU's path) and the shift path
  (``extrap_kwargs["max_disp"]``: JAX's CPU run takes ``_axis_resample``,
  the port the plain versions of K1 and K4, the card's kernels' CPU
  versions); also with noise and the resampled CDF target, on JAX's
  per-member draws handed over, and with SPN weights unmatched.
- ``forecast`` end to end on deterministic configurations (no noise, no
  resampling of the target), value by value with identical NaN sets,
  over the branches of ``tests/test_blending.py``; with SPN weights on
  JAX's weights handed over, the weights held on their own (``spn_run``).
- ``scan_inputs``' fields (the NWP stack and fields, the blended velocity,
  the NaN fill, the radar domain and minimum, the speed bound) bit for bit
  against the same steps in numpy, over the model counts, stack shapes,
  velocities, NaN and no-rain gates it branches on.

Without a CDF match the outputs are held within 1e-5 x span at every
pixel.  The loop ends in the exact CDF match (two stable sorts), which
hands each pixel the target quantile of its rank: where two pixels'
values are within rounding of each other their ranks may swap, and each
takes its neighbour's quantile (42 of 36864 pixels, up to 1.4e-3 x span,
with a time-varying velocity whose unmatched fields agree within 1.9e-6
x span).  So a matched output is held on its sorted values (the
distribution, within 1e-5 x span), at 99.8% of its pixels within 1e-4 x
span, on average within 1e-5 x span, and everywhere within 1e-2 x span.
The stochastic configurations are held by CRPS in
``tests/test_torch_blending_crps.py``."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_synthetic_sequence
from pysteps_tpu import blending as jblending
from pysteps_tpu import nowcasts as jnowcasts
from pysteps_tpu.blending import steps as jsteps
from pysteps_tpu.noise import fftgenerators as jfft
from pysteps_tpu_torch import blending as tblending
from pysteps_tpu_torch.blending import steps as tsteps
from pysteps_tpu_torch.noise import fftgenerators as tfft
from pysteps_tpu_torch.postprocessing import probmatching as tprob

SIDE, E, T = 64, 3, 3
DET = dict(n_ens_members=E, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0, seed=42,
           noise_method=None, resample_distribution=False)
PLAIN_TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    frames = make_synthetic_sequence(n_frames=9, shape=(SIDE, SIDE), velocity=(2.0, 1.0),
                                     seed=1)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    db = db.astype(np.float32)
    velocity = np.zeros((2, SIDE, SIDE), np.float32)
    velocity[0], velocity[1] = 2.0, 1.0
    nwp = (db[2:9] + 0.5 * np.random.RandomState(7).randn(7, SIDE, SIDE)).astype(np.float32)
    return db, velocity, nwp


@pytest.fixture(scope="module")
def skill_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("skill"))


def _held(out, ref, matched=True):
    """``out`` against ``ref`` (E, T, m, n): identical NaN sets, and the
    tolerances of the module docstring (``matched``: a CDF-matched
    output)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    span = np.nanmax(ref) - np.nanmin(ref)
    if span == 0:  # a constant forecast (the incremental mask of a dry radar)
        np.testing.assert_array_equal(out, ref)
        return
    diff = np.nan_to_num(np.abs(out - ref)) / span
    if not matched:
        assert diff.max() <= PLAIN_TOL, diff.max()
        return
    flat = lambda x: np.sort(np.nan_to_num(x, nan=-np.inf).reshape(x.shape[:2] + (-1,)), axis=-1)
    sorted_diff = np.nan_to_num(np.abs(flat(out) - flat(ref)), nan=0.0) / span
    assert sorted_diff.max() <= PLAIN_TOL, sorted_diff.max()
    assert np.mean(diff <= 1e-4) >= 0.998, np.mean(diff <= 1e-4)
    assert diff.mean() <= PLAIN_TOL and diff.max() <= 1e-2, (diff.mean(), diff.max())


def _capture(monkeypatch):
    """Record the arguments of the JAX forecast's ``_blending_scan``."""
    rec = {}
    orig = jsteps._blending_scan
    sig = inspect.signature(orig)

    def recording(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        rec.update(bound.arguments)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jsteps, "_blending_scan", recording)
    return rec


def _port_scan(rec, **kw):
    arrays = {k: np.asarray(v) for k, v in rec.items()
              if isinstance(v, (np.ndarray, jax.Array))}
    params, state = tsteps.params_from_numpy(arrays, "cpu", seed=0)
    return tsteps._blending_scan(
        params, state, rec["int_steps"], mask_method=rec["mask_method"],
        probmatching_method=rec["probmatching"],
        resample_distribution=rec["resample_distribution"], mask_rim=rec["mask_rim"],
        struct_radius=rec["struct_radius"], precip_thr=float(rec["precip_thr"]),
        max_disp=rec["max_disp"], vel_pert=rec["vel_pert"], p_par=rec["p_par"],
        p_perp=rec["p_perp"], vsf=float(rec["vsf"]), timestep_min=float(rec["timestep_min"]),
        use_noise=rec["use_noise"], **kw)


SCAN_BRANCHES = {
    "gather": {},
    "shift": {"extrap_kwargs": {"max_disp": 12}},
    # SPN's weights reach +-670 (see ``spn_run``): the blend multiplies
    # the rounding of the init's cascades by them (1.6e-5 x span from the
    # port's own init with JAX's weights), so the unmatched SPN output is
    # held from JAX's init
    "spn_unmatched": dict(weights_method="spn", probmatching_method=None),
}


@pytest.mark.parametrize("branch", list(SCAN_BRANCHES))
def test_scan_from_jax_init(data, skill_dir, branch, monkeypatch):
    db, velocity, nwp = data
    rec = _capture(monkeypatch)
    extra = SCAN_BRANCHES[branch]
    ref = np.asarray(jblending.get_method("steps")(
        db[:3], nwp[None], velocity, velocity[None], T, 5, outdir_path_skill=skill_dir,
        **dict(DET, **extra)))
    assert rec["max_disp"] == (12 if branch == "shift" else None)
    out = _port_scan(rec)
    _held(out.numpy(), ref, matched=extra.get("probmatching_method", "cdf") == "cdf")


def _jax_draws(rec, m, n):
    """JAX's per-lead spectral white noise (E, m, n//2+1) and Bernoulli picks
    (E, m*n) of the resampled target, from the forecast's member keys."""
    keys = list(rec["member_keys"])
    w = np.asarray(rec["weights_t"])
    mm = np.asarray(rec["member_model"])
    whites, picks = [], []
    for t in range(rec["int_steps"]):
        split = [jax.random.split(k) for k in keys]
        keys = [s[0] for s in split]
        whites.append(np.stack([np.asarray(jfft._spectral_white(s[1], (m, n))) for s in split]))
        pk = []
        for j, k in enumerate(keys):
            wj = jnp.asarray(w[t, mm[j]])
            p_radar = jnp.sum(wj[0]) / jnp.maximum(jnp.sum(wj[0]) + jnp.sum(wj[1]), 1e-12)
            pk.append(np.asarray(jax.random.bernoulli(jax.random.fold_in(k, t), p_radar,
                                                      (m * n,))))
        picks.append(np.stack(pk))
    return whites, picks


@pytest.mark.parametrize("adj", [None, "fixed"])
def test_scan_with_noise_and_resampling_on_jax_draws(data, skill_dir, adj, monkeypatch):
    db, velocity, nwp = data
    rec = _capture(monkeypatch)
    kw = dict(DET, noise_method="nonparametric", resample_distribution=True,
              noise_stddev_adj=adj)
    ref = np.asarray(jblending.get_method("steps")(
        db[:3], nwp[None], velocity, velocity[None], T, 5, outdir_path_skill=skill_dir, **kw))
    whites, picks = _jax_draws(rec, SIDE, SIDE)
    it_w, it_p = iter(whites), iter(picks)
    monkeypatch.setattr(tfft, "_spectral_white", lambda g, s, b: torch.from_numpy(next(it_w)))
    monkeypatch.setattr(tprob, "_bernoulli", lambda g, p, shape: torch.from_numpy(next(it_p)))
    out = _port_scan(rec)
    _held(out.numpy(), ref)


BRANCHES = {
    "incremental_cdf": {},
    "obs_mean": dict(mask_method="obs", probmatching_method="mean"),
    "spn": dict(weights_method="spn"),
    "no_mask_no_match": dict(mask_method=None, probmatching_method=None),
    "end_weights": dict(timestep_start_full_nwp_weight=1),
    "smooth_radar_mask": dict(smooth_radar_mask_range=12, domain_nan=True),
    "conditional": dict(conditional=True),
    "multimodel": dict(models=2),
    "blend_nwp_members": dict(models=2, blend_nwp_members=True),
    "time_varying_velocity": dict(vel_t=True),
    "time_varying_velocity_unmatched": dict(vel_t=True, probmatching_method=None),
    "static_nwp": dict(static_nwp=True),
    "shift_path": dict(extrap_kwargs={"max_disp": 12}),
}


def _branch_inputs(data, kw):
    db, velocity, nwp = data
    kw = dict(kw)
    precip = db[:3].copy()
    nwp_in, vel_in = nwp[None], velocity[None]
    models = kw.pop("models", 1)
    if models == 2:
        rng = np.random.RandomState(3)
        nwp_in = np.stack([nwp, nwp + 0.3 * rng.randn(*nwp.shape).astype(np.float32)])
        vel_in = np.stack([velocity, 0.8 * velocity])
    if kw.pop("vel_t", False):
        vel_in = np.stack([velocity * (1 + 0.05 * t) for t in range(T + 1)])[None]
    if kw.pop("static_nwp", False):
        nwp_in = nwp_in[:, 0]
    if kw.pop("domain_nan", False):
        precip[:, :, :6] = np.nan
    return precip, nwp_in, vel_in, kw


def _forecasts(data, skill_dir, branch):
    """JAX's and the port's forecast of ``branch`` (numpy, torch)."""
    precip, nwp_in, vel_in, kw = _branch_inputs(data, BRANCHES[branch])
    args = (precip, nwp_in, data[1], vel_in, T, 5)
    kw = dict(DET, outdir_path_skill=skill_dir, **kw)
    ref = np.asarray(jblending.get_method("steps")(*args, **kw))
    return ref, tblending.get_method("steps")(*args, device="cpu", **kw)


@pytest.fixture(scope="module")
def spn_run(data, skill_dir):
    """The ``spn`` branch, with SPN's weights as JAX computes them handed
    to the port.  SPN2013's weights are the inverse covariance of the
    radar and NWP cascades times their lead-time correlations; on the
    first level the two cascades correlate at 0.99994, the covariance's
    condition number is 3.3e4 (3.2e3 and 4.9e2 on the next two levels)
    and the weights are -668.8 and +669.8.  The packages' float32
    rounding moves the correlations by up to 1.6e-6 and the covariances
    by up to 4e-8, and the weights by up to 4.8e-3 (1.1e-3 with JAX's
    correlations handed over: the covariances alone move them as much).
    So the weights are held on their inputs and their code, and the loop
    on JAX's weights.  Records JAX's (correlations, covariance) pairs and
    weights, the port's pairs, and both forecasts."""
    jax_pairs, jax_weights, port_pairs = [], [], []
    j_spn = jsteps.calculate_weights_spn

    def jax_recording(correlations, covariance):
        jax_pairs.append((np.array(correlations), np.array(covariance)))
        jax_weights.append(j_spn(correlations, covariance))
        return jax_weights[-1]

    def port_handed_jax_weights(correlations, covariance):
        port_pairs.append((np.array(correlations), np.array(covariance)))
        return jax_weights[len(port_pairs) - 1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "calculate_weights_spn", jax_recording)
        mp.setattr(tsteps, "calculate_weights_spn", port_handed_jax_weights)
        ref, out = _forecasts(data, skill_dir, "spn")
    assert len(port_pairs) == len(jax_pairs) == T * DET["n_cascade_levels"]
    return dict(ref=ref, out=out, jax_pairs=jax_pairs, jax_weights=jax_weights,
                port_pairs=port_pairs)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_forecast_deterministic(data, skill_dir, branch, request):
    if branch == "spn":
        run = request.getfixturevalue("spn_run")
        ref, out = run["ref"], run["out"]
    else:
        ref, out = _forecasts(data, skill_dir, branch)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    _held(out.numpy(), ref,
          matched=BRANCHES[branch].get("probmatching_method", "cdf") == "cdf")


def test_spn_weights_equal_jax_on_its_inputs(spn_run):
    """The port's SPN weights equal JAX's bit for bit on each (correlations,
    covariance) pair of JAX's forecast."""
    for (correlations, covariance), ref in zip(spn_run["jax_pairs"], spn_run["jax_weights"]):
        np.testing.assert_array_equal(tsteps.calculate_weights_spn(correlations, covariance),
                                      ref)
    assert np.linalg.cond(spn_run["jax_pairs"][0][1]) > 1e4


# the inputs of the SPN weights (correlations and covariances near 1):
# within 32 float32 ulps of 1 (measured 1.6e-6 and 4e-8)
SPN_INPUT_TOL = 32 * float(np.finfo(np.float32).eps)


def test_spn_weight_inputs_within_rounding(spn_run):
    """The port's lead-time correlations (the extrapolation's from its AR
    fit, the NWP's from its skill at t = 0) and its radar-NWP covariances,
    the inputs of each SPN weight, against JAX's."""
    for (c_ref, cov_ref), (c, cov) in zip(spn_run["jax_pairs"], spn_run["port_pairs"]):
        np.testing.assert_allclose(c, c_ref, rtol=0, atol=SPN_INPUT_TOL)
        np.testing.assert_allclose(cov, cov_ref, rtol=0, atol=SPN_INPUT_TOL)


def test_forecast_external_nowcast(data, skill_dir):
    db, velocity, nwp = data
    external = np.asarray(jnowcasts.get_method("steps")(
        db[:3], velocity, T, n_ens_members=E, precip_thr=-10.0, kmperpixel=1.0, timestep=5,
        seed=3))
    kw = dict(DET, outdir_path_skill=skill_dir, precip_nowcast=external,
              nowcasting_method="external_nowcast")
    args = (db[:3], nwp[None], velocity, velocity[None], T, 5)
    ref = np.asarray(jblending.get_method("steps")(*args, **kw))
    out = tblending.get_method("steps")(*args, device="cpu", **kw)
    _held(out.numpy(), ref)
    with pytest.raises(ValueError):
        tblending.get_method("steps")(*args, device="cpu", **dict(kw, precip_nowcast=external[:2]))


@pytest.mark.parametrize("which", ["radar", "nwp", "both"])
def test_forecast_zero_inputs(data, skill_dir, which):
    db, velocity, nwp = data
    precip = np.full_like(db[:3], -15.0) if which in ("radar", "both") else db[:3]
    nwp_in = np.full_like(nwp, -15.0) if which in ("nwp", "both") else nwp
    args = (precip, nwp_in[None], velocity, velocity[None], 2, 5)
    kw = dict(DET, outdir_path_skill=skill_dir)
    ref = np.asarray(jblending.get_method("steps")(*args, **kw))
    out = tblending.get_method("steps")(*args, device="cpu", **kw)
    _held(out.numpy(), ref)
    if which == "both":
        assert np.all(out.numpy() == -15.0)


def test_argument_errors_and_mesh(data):
    db, velocity, nwp = data
    args = (db[:3], nwp[None], velocity, velocity[None], T, 5)
    for bad in (dict(nowcasting_method="x"), dict(nowcasting_method="external_nowcast"),
                dict(timestep_start_full_nwp_weight=-1), dict(timestep_start_full_nwp_weight=T),
                dict(precip_thr=None), dict(weights_method="nope")):
        kw = dict(DET, **bad)
        with pytest.raises(ValueError):
            jblending.get_method("steps")(*args, **kw)
        with pytest.raises(ValueError):
            tblending.get_method("steps")(*args, device="cpu", **kw)
    with pytest.raises(TypeError):
        tblending.get_method("steps")(*args, device="cpu", mesh=object(), **DET)


STOCH = dict(n_ens_members=4, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0,
             seed=5, noise_method="nonparametric", resample_distribution=True)


def _plain(data, skill_dir, **kw):
    db, velocity, nwp = data
    return tblending.get_method("steps")(
        db[:3], nwp[None], velocity, velocity[None], kw.pop("timesteps", 4), 5,
        device="cpu", outdir_path_skill=skill_dir, **dict(STOCH, **kw))


def test_streaming_callback_matches_the_plain_call(data, skill_dir):
    frames = []
    res = _plain(data, skill_dir, callback=frames.append, return_output=False)
    full = _plain(data, skill_dir).numpy()
    assert res is None and len(frames) == 4
    assert all(isinstance(f, np.ndarray) and f.shape == (4, SIDE, SIDE) for f in frames)
    np.testing.assert_array_equal(np.stack(frames, axis=1), full)
    frames2 = []
    out = _plain(data, skill_dir, callback=frames2.append)
    np.testing.assert_array_equal(np.stack(frames2, axis=1), out.numpy())


def test_member_chunk_matches_the_plain_call(data, skill_dir):
    det = dict(noise_method=None, resample_distribution=False)
    full = _plain(data, skill_dir, **det).numpy()
    chunked = _plain(data, skill_dir, member_chunk=2, **det).numpy()
    np.testing.assert_allclose(chunked, full, atol=1e-6 * (full.max() - full.min()))
    # with noise the chunked run draws each chunk's leads in turn: another
    # stream of the same law, members that spread
    noisy = _plain(data, skill_dir, member_chunk=2)
    assert float(noisy.std(dim=0).mean()) > 0


def test_bfloat16_output_is_the_float32_output_rounded(data, skill_dir):
    full = _plain(data, skill_dir)
    half = _plain(data, skill_dir, output_dtype="bfloat16")
    assert half.dtype == torch.bfloat16
    np.testing.assert_array_equal(half.float().numpy(), full.to(torch.bfloat16).float().numpy())


def test_list_timesteps_interpolate_the_plain_call(data, skill_dir):
    full = _plain(data, skill_dir, timesteps=3).numpy()
    sub = _plain(data, skill_dir, timesteps=[1, 2.5, 3]).numpy()
    assert sub.shape == (4, 3, SIDE, SIDE)
    np.testing.assert_array_equal(sub[:, 0], full[:, 0])
    np.testing.assert_array_equal(sub[:, 2], full[:, 2])
    np.testing.assert_allclose(sub[:, 1], 0.5 * full[:, 1] + 0.5 * full[:, 2], atol=1e-5)


def test_measure_time_and_nowcaster_class(data, skill_dir):
    db, velocity, nwp = data
    out, init_s, loop_s = _plain(data, skill_dir, measure_time=True)
    assert init_s >= 0 and loop_s >= 0
    cfg = tsteps.StepsBlendingConfig(
        precip_threshold=-10.0, kmperpixel=1.0, timestep=5, n_ens_members=4,
        seed=5, outdir_path_skill=skill_dir)
    caster = tsteps.StepsBlendingNowcaster(db[:3], nwp[None], velocity, velocity[None], 4,
                                           steps_blending_config=cfg, device="cpu")
    np.testing.assert_array_equal(caster.compute_forecast().numpy(), out.numpy())
    assert [f.name for f in tsteps.StepsBlendingConfig.__dataclass_fields__.values()] == [
        f.name for f in jsteps.StepsBlendingConfig.__dataclass_fields__.values()]


# scan_inputs prepares its fields on the device the forecast runs on, and
# must give what the same steps give in float32 numpy on the host, bit for
# bit (`_host_prepared`).
PREP = dict(n_ens_members=2, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0, seed=3,
            noise_method=None)
PREP_CASES = {
    "one_model": {},
    "two_models": dict(models=2),
    "static_nwp": dict(static_nwp=True),
    "time_varying_velocity": dict(vel_t=True),
    "nan_radar_and_nwp": dict(domain_nan=True, nwp_nan=True),
    "blend_nwp_members": dict(models=2, blend_nwp_members=True),
    "dry_nwp": dict(dry_nwp=True),
    "rain_only_in_older_frames": dict(older_rain=True, dry_nwp=True),
}


def _prep_inputs(data, case):
    """(precip, precip_models, velocity, velocity_models, keywords) of
    ``PREP_CASES[case]``: ``_branch_inputs``' and three more."""
    db, velocity, _ = data
    kw = dict(PREP_CASES[case])
    more = {k: kw.pop(k, False) for k in ("nwp_nan", "dry_nwp", "older_rain")}
    vel_t = kw.get("vel_t", False)
    precip, nwp_in, vel_m, kw = _branch_inputs(data, kw)
    if vel_t:
        # T leads of model velocity: the last lead takes the last given
        vel_m = vel_m[:, :T]
    if more["nwp_nan"]:
        nwp_in = nwp_in.copy()
        nwp_in[..., -4:, :7] = np.nan
    if more["dry_nwp"]:
        nwp_in = np.full_like(nwp_in, -15.0)
    if more["older_rain"]:
        # two frames before the AR window, the only radar rain
        precip = np.concatenate([db[:2], np.full_like(db[:3], -15.0)])
    return precip, nwp_in, velocity, vel_m, kw


def _host_prepared(precip, nwp_in, velocity, vel_m, weights_t, weights_2d, blend):
    """The loop's fields from the inputs and the per-lead weights (T,
    n_models, 3, k), in float32 numpy; the NWP cascades and the model
    means of the NWP fields in torch on the CPU."""
    precip = np.asarray(precip).astype(np.float32)[-3:]
    pm = np.asarray(nwp_in).astype(np.float32)
    if pm.ndim == 3:
        pm = np.repeat(pm[:, None], T + 1, axis=1)
    vm = np.asarray(vel_m).astype(np.float32)
    domain_mask = ~np.isfinite(precip[-1])
    precip_min = float(np.nanmin(precip))
    precip = np.where(np.isfinite(precip), precip, precip_min)
    pm = np.where(np.isfinite(pm), pm, precip_min)
    w_e, w_n = weights_t[:, :, 0, 1], weights_t[:, :, 1, 1]
    tot = np.maximum(w_e + w_n, 1e-12)
    if vm.ndim == 5:
        vm_t = np.swapaxes(vm[:, np.clip(np.arange(1, T + 1), 0, vm.shape[1] - 1)], 0, 1)
    else:
        vm_t = vm[None, :, :2]
    vb = (w_e[..., None, None, None] * velocity[None, None]
          + w_n[..., None, None, None] * vm_t) / tot[..., None, None, None]
    levels, _, _ = tsteps.decompose_core(torch.as_tensor(pm[:, : T + 1]), weights_2d,
                                        normalize=True)
    fields = torch.as_tensor(pm[:, 1: T + 1])
    if blend:
        vb = vb.mean(axis=1, keepdims=True)
        levels = levels.mean(dim=0, keepdim=True)
        fields = fields.mean(dim=0, keepdim=True)
    return dict(
        velocity_blend=vb, nwp_fields=fields.transpose(0, 1).numpy(),
        nwp_cascades=levels[:, 1: T + 1].transpose(0, 1).numpy(), precip_last=precip[-1],
        domain_mask=domain_mask, precip_min=np.float32(precip_min),
        vmax_bound=float(np.abs(vb).max()),
    )


@pytest.mark.parametrize("case", list(PREP_CASES))
def test_scan_inputs_prepares_the_host_paths_fields(data, skill_dir, case, monkeypatch):
    precip, nwp_in, velocity, vel_m, kw = _prep_inputs(data, case)
    weights = []
    bps = tsteps.calculate_weights_bps
    monkeypatch.setattr(tsteps, "calculate_weights_bps",
                        lambda corr: weights.append(bps(corr)) or weights[-1])
    inputs = tsteps.scan_inputs(precip, nwp_in, velocity, vel_m, T, 5, device="cpu",
                                outdir_path_skill=skill_dir, **dict(PREP, **kw))
    n_models = np.asarray(nwp_in).shape[0]
    weights_t = np.asarray(weights, np.float32).reshape(T, n_models, 3, -1)
    ref = _host_prepared(precip, nwp_in, velocity, vel_m, weights_t,
                         inputs.params.weights_2d, kw.get("blend_nwp_members", False))
    got = {k: getattr(inputs.params, k) for k in ref if k != "vmax_bound"}
    for name, tensor in got.items():
        assert tensor.dtype == (torch.bool if name == "domain_mask" else torch.float32), name
        np.testing.assert_array_equal(tensor.numpy(), ref[name], err_msg=name)
    assert inputs.vmax_bound == ref["vmax_bound"]


def test_scan_inputs_of_dry_radar_and_nwp_is_none(data, skill_dir):
    db, velocity, nwp = data
    dry = np.full_like(db[:3], -15.0)
    assert tsteps.scan_inputs(dry, np.full_like(nwp, -15.0)[None], velocity, velocity[None], T,
                              5, device="cpu", outdir_path_skill=skill_dir, **PREP) is None
    with pytest.raises(ValueError):
        tsteps.scan_inputs(db[:3], nwp[None], velocity, velocity[None], T, 5, device="cpu",
                           outdir_path_skill=skill_dir, **dict(PREP, precip_thr=None))
