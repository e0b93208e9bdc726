"""Multi-rank checks of the port's ``parallel/``, ``verification/parallel``
and the ``mesh=`` of blending, the PCA fit, the EnKFs and VET on the CPU:
ranks spawned into one ``gloo`` process group with a file rendezvous, so
that concurrent test workers never share a port.

This module imports only torch, numpy, the port and ``helpers`` (numpy), so
that the spawned ranks never import JAX.  :func:`run_group` starts the
ranks, waits for them within a deadline and returns what each rank saved;
the tests compare those results with the JAX package in their own process.
"""

import contextlib
import datetime
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# spawned ranks import this module by name: the tests and the repo's root
sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]
from helpers import make_synthetic_sequence  # noqa: E402

WORLD = 4
# sharded_steps cases: 128^2 grid, 4 members, 3 leads (tests/test_parallel.py)
SS_KW = dict(n_ens_members=4, precip_thr=-10.0, kmperpixel=1.0, timestep=5, seed=7)
# the MODEL_PARITY.json recipe at 128^2: 16 members, 6 leads, seeds 11 and 22
LAW_SEEDS = (11, 22)
LAW_KW = dict(n_ens_members=16, n_cascade_levels=8, precip_thr=-10.0, kmperpixel=1.0,
              timestep=5)
# STEPS' mesh= cases: (ens ranks, forecast kwargs) at 64^2, 2 leads
STEPS_KW = dict(n_ens_members=8, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0,
                timestep=5, seed=11, domain="spectral")
STEPS_CASES = {
    "ens2": (2, {}),
    "ens2_partial_chunks": (2, dict(n_ens_members=6, member_chunk=2)),
    "ens4_ssft_chunks": (4, dict(noise_method="ssft", noise_kwargs={"win_size": 32},
                                 member_chunk=2)),
}
# _dilated_mask_halo cases on 4 row shards of 16: (kr, r), a halo of 12
# from the neighbours and one of 21 gathered; the mask's threshold
MASK_CASES = ((2, 10), (1, 20))
MASK_THR = 1.0
# rfft2_local cases: (y ranks, width); 96 and 90 pad n//2+1 to the shards
FFT_CASES = {"y2_n96": (2, 96), "y4_n96": (4, 96), "y4_n90": (4, 90)}


def ss_inputs():
    """tests/test_parallel.py::test_spatially_sharded_steps_matches_single_device's
    inputs."""
    frames = make_synthetic_sequence(n_frames=6, shape=(128, 128), velocity=(2.0, 1.0), seed=3)
    db = (10.0 * np.log10(np.maximum(frames, 0.1))).astype(np.float32)
    vel = np.zeros((2, 128, 128), np.float32)
    vel[0], vel[1] = 2.0, 1.0
    return db[:3], vel


def law_inputs():
    """A 128^2 sequence with growth and decay (made at 256^2, subsampled),
    motion (1.7, 0.6) px a step: 3 inputs in dB and 6 leads of truth."""
    frames = make_synthetic_sequence(
        n_frames=9, shape=(256, 256), velocity=(3.4, 1.2), seed=42, evolution=0.2,
    )[:, ::2, ::2]
    db = np.where(frames >= 0.1, 10.0 * np.log10(np.maximum(frames, 0.1)), -15.0)
    vel = np.zeros((2, 128, 128), np.float32)
    vel[0], vel[1] = 1.7, 0.6
    return db[:3].astype(np.float32), vel, frames[3:]


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


def law_scores(fc, truth):
    """The ``MODEL_PARITY.json`` recipe's numbers of a dB forecast
    (E, T, m, n) against the rain-rate truth (T, m, n): the CRPS over all
    leads and the spread/error ratio, in rain rate."""
    fc = np.asarray(fc, np.float64)
    rr = 10.0 ** (fc / 10.0) * (fc > -10)
    crps = np.mean([_crps(rr[:, t], truth[t]) for t in range(rr.shape[1])])
    spread = np.nanmean(np.nanstd(rr, axis=0, ddof=1))
    err = np.sqrt(np.nanmean((np.nanmean(rr, axis=0) - truth) ** 2))
    return crps, spread / err


def law_cpu(rank):
    """The law runs of ``sharded_steps`` on a 1 x 1 x 1 CPU mesh (the
    card's run is held against these)."""
    from pysteps_tpu_torch.parallel import make_mesh, sharded_steps

    mesh = make_mesh(ens=1, device_type="cpu")
    db, vel, _ = law_inputs()
    torch.set_num_threads(os.cpu_count() or 1)
    return {f"law_{seed}": _np(sharded_steps.forecast(db, vel, 6, mesh, seed=seed, **LAW_KW))
            for seed in LAW_SEEDS}


def conus_inputs(m=2048, n=2048):
    """The JAX package's dry-run inputs (``__graft_entry__.py:18-27``):
    gamma-distributed rain in dB, a constant (1, 0.5) px motion."""
    rng = np.random.RandomState(0)
    precip = rng.gamma(2.0, 2.0, (3, m, n)).astype(np.float32)
    precip[precip < 1.0] = 0.0
    precip_db = np.where(
        precip >= 0.1, 10.0 * np.log10(np.maximum(precip, 0.1)), -15.0
    ).astype(np.float32)
    velocity = np.zeros((2, m, n), np.float32)
    velocity[0], velocity[1] = 1.0, 0.5
    return precip_db, velocity


def steps_inputs():
    frames = make_synthetic_sequence(n_frames=3, shape=(64, 64), velocity=(2.0, 1.0), seed=0)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    vel = np.zeros((2, 64, 64), np.float32)
    vel[0], vel[1] = 2.0, 1.0
    return db.astype(np.float32), vel


def warp_inputs():
    """tests/test_parallel.py::test_sharded_warp_matches_single_device's."""
    rng = np.random.RandomState(0)
    m = n = 64
    field = rng.rand(m, n).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    disp = np.stack([2.0 + 0.5 * np.sin(yy / 10.0),
                     -1.5 + 0.5 * np.cos(xx / 9.0)]).astype(np.float32)
    return field, disp, 8


def match_inputs():
    """Two 64^2 members to match and a target with a dry floor."""
    rng = np.random.RandomState(5)
    fields = rng.gamma(1.0, 2.0, (2, 64, 64)).astype(np.float32)
    fields[:, :20] = 0.0
    target = np.where(rng.rand(64, 64) < 0.6, -15.0,
                      10 * rng.rand(64, 64)).astype(np.float32)
    return fields, target


def verification_inputs():
    """tests/test_parallel.py::test_distributed_verification_matches_serial's."""
    rng = np.random.RandomState(3)
    C, m, n = 8, 32, 32
    pred = rng.gamma(1.0, 2.0, (C, m, n)).astype(np.float32)
    obs = rng.gamma(1.0, 2.0, (C, m, n)).astype(np.float32)
    ens = rng.gamma(1.0, 2.0, (C, 5, m, n)).astype(np.float32)
    return pred, obs, ens


def fft_field(n):
    return np.random.RandomState(0).randn(64, n).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _one_rank_meshes(world):
    """One 1 x 1 x 1 mesh per rank (every rank builds all of them, in order)."""
    from torch.distributed.device_mesh import DeviceMesh

    return [DeviceMesh("cpu", torch.full((1, 1, 1), r), mesh_dim_names=("ens", "y", "x"))
            for r in range(world)]


def parallel_checks(rank):
    """Every check of tests/test_torch_parallel.py that needs several ranks;
    returns this rank's results (name -> array)."""
    from pysteps_tpu_torch import nowcasts
    from pysteps_tpu_torch.parallel import dist_fft, halo, make_mesh, sharded_steps
    from pysteps_tpu_torch.parallel.mesh import all_gather_cat, shard_ensemble
    from pysteps_tpu_torch.verification import parallel as vparallel

    res = {}
    # the mesh's axes and each rank's member block
    mesh = make_mesh(ens=2, y=2, device_type="cpu")
    res["mesh_shape"] = np.array(mesh.shape)
    res["mesh_coord"] = np.array(mesh.get_coordinate())
    res["mesh_names"] = np.array(mesh.mesh_dim_names)
    block = shard_ensemble({"a": np.arange(8 * 4 * 4, dtype=np.float32).reshape(8, 4, 4)}, mesh)
    res["ens_block"] = _np(block["a"])

    # halo-exchange warp on 4 row shards
    mesh_y4 = make_mesh(ens=1, y=4, device_type="cpu")
    field, disp, max_disp = warp_inputs()
    res["sharded_warp"] = _np(halo.sharded_warp(field, disp, mesh_y4, max_disp, cval=0.0))

    # the pencil FFT: spectrum gathered over the columns, round trip
    for name, (y, n) in FFT_CASES.items():
        fmesh = mesh_y4 if y == 4 else make_mesh(ens=1, y=2, device_type="cpu")
        if fmesh.get_coordinate() is None:
            continue
        f = torch.as_tensor(fft_field(n))
        rows = halo._local_rows(f, fmesh)
        spec = dist_fft.rfft2_local(rows, fmesh)
        back = dist_fft.irfft2_local(spec, (64, n), fmesh)
        res[f"fft_{name}_spec"] = _np(all_gather_cat(spec, fmesh, "y", dim=-1))
        res[f"fft_{name}_back"] = _np(all_gather_cat(back, fmesh, "y", dim=-2))
        res[f"fft_{name}_weight"] = _np(all_gather_cat(
            dist_fft.spec_weight_local(n, y, fmesh), fmesh, "y"))
        res[f"fft_{name}_mask"] = _np(all_gather_cat(
            dist_fft.spec_col_mask(n, y, fmesh), fmesh, "y"))

    # distributed verification over 4 case shards
    mesh_e4 = make_mesh(ens=4, device_type="cpu")
    pred, obs, ens = verification_inputs()
    dc = vparallel.sharded_det_cat_accum(pred, obs, 1.0, mesh_e4)
    for k in ("hits", "false_alarms", "misses", "correct_negatives"):
        res[f"detcat_{k}"] = _np(dc[k])
    res["detcat_dtype"] = np.array(str(dc["hits"].dtype))
    res["crps_state"] = np.array([*vparallel.sharded_crps_accum(ens, obs, mesh_e4).values()])
    fss = vparallel.sharded_fss_accum(pred, obs, 1.0, 4, mesh_e4)
    res["fss_state"] = np.array([fss["sum_obs_sq"], fss["sum_fct_obs"], fss["sum_fct_sq"]])
    accum, compute = vparallel.distributed_verify("det_cat", mesh_e4, thr=1.0)
    res["detcat_csi"] = np.array(float(compute(accum(pred, obs), "CSI")))

    # the psum matchers on 4 row shards
    fields, target = match_inputs()
    tstate = sharded_steps._prepare_pwl_target(torch.as_tensor(target))
    rows = halo._local_rows(torch.as_tensor(fields), mesh_y4)
    size = float(fields[0].size)
    m_psum = sharded_steps._match_cdf_psum(rows, tstate, size, mesh_y4)
    ranked, zvalue, c_t, tlo, tscale, n_wet = tstate
    m_binned = sharded_steps._match_cdf_psum_binned(
        rows, zvalue, c_t, tlo, tscale, n_wet, ranked[-1] - 1.0, size, mesh_y4)
    res["match_psum"] = _np(all_gather_cat(m_psum, mesh_y4, "y", dim=-2))
    res["match_binned"] = _np(all_gather_cat(m_binned, mesh_y4, "y", dim=-2))
    # the rim mask with its own exchange, from the neighbours and gathered
    for kr, r in MASK_CASES:
        mask = sharded_steps._dilated_mask_halo(rows, MASK_THR, kr, r, mesh_y4)
        res[f"mask_{kr}_{r}"] = _np(all_gather_cat(mask, mesh_y4, "y", dim=-2))

    # y-sharded STEPS on 2 ens x 2 y, with and without BPS
    db, vel = ss_inputs()
    for vp in (None, "bps"):
        out = sharded_steps.forecast(db, vel, 3, mesh, vel_pert_method=vp, **SS_KW)
        res[f"ss_2x2_{vp}"] = _np(out)

    # 1 x 1 runs, one a rank: the two layouts' reference and the law runs
    own = _one_rank_meshes(dist.get_world_size())[rank]
    if rank < 2:
        vp = (None, "bps")[rank]
        res[f"ss_1x1_{vp}"] = _np(sharded_steps.forecast(db, vel, 3, own, vel_pert_method=vp,
                                                         **SS_KW))
    else:
        seed = LAW_SEEDS[rank - 2]
        ldb, lvel, _ = law_inputs()
        res[f"law_{seed}"] = _np(sharded_steps.forecast(ldb, lvel, 6, own, seed=seed, **LAW_KW))

    # STEPS' mesh=: the members split over "ens"; the unsharded forecast
    # on one rank, with the same (one) thread, for the reference
    sdb, svel = steps_inputs()
    for name, (ens_n, kw) in STEPS_CASES.items():
        smesh = make_mesh(ens=ens_n, device_type="cpu")
        kw = dict(STEPS_KW, **kw)
        if smesh.get_coordinate() is not None:
            res[f"steps_{name}"] = _np(nowcasts.get_method("steps")(
                sdb, svel, 2, mesh=smesh, device="cpu", **kw))
        if rank == (ens_n % WORLD):
            res[f"steps_{name}_plain"] = _np(nowcasts.get_method("steps")(
                sdb, svel, 2, device="cpu", **kw))
    return res


@contextlib.contextmanager
def as_ens_rank(block, ens=2):
    """STEPS' (and STEPS blending's) ``mesh=`` branch on a mesh of one rank,
    run as the rank of an "ens" dimension of ``ens`` ranks that holds the
    members ``block`` (start, stop): ``member_block`` gives the block,
    ``axis_size`` ``ens`` ranks on "ens", and the closing all-gather
    returns the block alone.
    So each rank's block of a sharded forecast runs in turn on one card."""
    from pysteps_tpu_torch.blending import steps as blend_steps
    from pysteps_tpu_torch.nowcasts import steps

    mods = (steps, blend_steps)
    orig = [(mod.axis_size, mod.member_block, mod.all_gather_cat) for mod in mods]
    for mod, (size, _, _) in zip(mods, orig):
        mod.axis_size = lambda mesh, name, size=size: ens if name == "ens" else size(mesh, name)
        mod.member_block = lambda n, mesh, axis_name="ens": tuple(block)
        mod.all_gather_cat = lambda t, mesh, name, dim=0: t
    try:
        yield
    finally:
        for mod, fns in zip(mods, orig):
            mod.axis_size, mod.member_block, mod.all_gather_cat = fns


def block_launches(block, E, T, member_chunk=None, ar_order=2):
    """One rank's kernel launches in STEPS' chain path on the card, from
    the code (``nowcasts/steps.py``): the replicated init's K1 (ar_order
    unit steps of 2 velocity samples and one warp of the inputs, one
    launch an axis each) and its one rim from a mask; each lead, for each
    member chunk that holds members of ``block``, 2 velocity samples (K1)
    and one launch of each chain stage."""
    mc = member_chunk or E
    chunks = sum(1 for c0 in range(0, E, mc) if min(c0 + mc, block[1]) > max(c0, block[0]))
    k1 = ar_order * 2 + 1 + 2 * T * chunks
    return {"resample_axis0": k1, "resample_axis1": k1, "chain_match_vert_rim": T * chunks,
            "chain_horiz": T * chunks, "rim_from_mask": 1}


# sharded blending cases, tests/test_parallel.py:72-219: (mesh (ens, y),
# input seed, grid, forecast kwargs) at 2 leads, 6 levels
BLEND_KW = dict(n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0)
BLEND_CASES = {
    "y_mean": ((2, 2), 2, (64, 64), dict(n_ens_members=4, seed=11, probmatching_method="mean")),
    "ens4": ((4, 1), 2, (64, 64), dict(n_ens_members=8, seed=11)),
    "inv_1x2": ((1, 2), 9, (64, 64), dict(n_ens_members=4, seed=3, vel_pert_method="bps")),
    "inv_2x2": ((2, 2), 9, (64, 64), dict(n_ens_members=4, seed=3, vel_pert_method="bps")),
    "halo_1x2": ((1, 2), 13, (32, 64), dict(n_ens_members=2, seed=3, vel_pert_method="bps")),
    "halo_1x4": ((1, 4), 13, (32, 64), dict(n_ens_members=2, seed=3, vel_pert_method="bps")),
}
# the unsharded forecasts a rank also runs, on its one thread: (case, rank)
BLEND_PLAIN = {"ens4": 1, "y_mean": 2}
# VET on 4 row shards (tests/test_parallel.py:222-241)
VET_KW = dict(sectors=((8, 4), (8, 4)), options={"maxiter": 40}, verbose=False)
VET_SECTORS = (8, 4)
VET_SMOOTH = 1e3
# PCA fits: (mesh (ens, y), features) on 8 members, the second padded
PCA_CASES = {"y4": ((1, 4), 1000), "ens4_pad": ((4, 1), 1001)}


def blend_inputs(seed, shape=(64, 64)):
    """tests/test_parallel.py's blending inputs: 7 synthetic frames in dB,
    the first 3 observed, a (2, 1) px motion, one NWP model from frames
    2-5 with 0.5 randn from ``RandomState(5)``."""
    frames = make_synthetic_sequence(n_frames=7, shape=shape, velocity=(2.0, 1.0), seed=seed)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    db = db.astype(np.float32)
    vel = np.zeros((2,) + shape, np.float32)
    vel[0], vel[1] = 2.0, 1.0
    nwp = db[2:6] + 0.5 * np.random.RandomState(5).randn(4, *shape).astype(np.float32)
    return db[:3], nwp[None], vel, vel[None]


def blend_case(name, skill_dir, mesh=None, **over):
    """Case ``name`` of ``BLEND_CASES`` through ``blending.get_method("steps")``
    on the CPU, with ``mesh`` (None: unsharded)."""
    from pysteps_tpu_torch import blending

    _, seed, shape, kw = BLEND_CASES[name]
    return blending.get_method("steps")(*blend_inputs(seed, shape), 2, 5, mesh=mesh,
                                        outdir_path_skill=skill_dir, device="cpu",
                                        **dict(BLEND_KW, **kw, **over))


def vet_inputs():
    frames = make_synthetic_sequence(n_frames=2, shape=(64, 64), velocity=(2.0, 1.0), seed=4)
    return np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)


def vet_cost_inputs():
    """A template, target, mask and sector displacement of the sharded VET
    cost check (64^2, 8 x 4 sectors)."""
    db = vet_inputs().astype(np.float32)
    mask = np.zeros((64, 64), bool)
    mask[:3] = True
    x = np.random.RandomState(3).uniform(-2.0, 2.0, 2 * 8 * 4).astype(np.float32)
    return db[0], db[1], mask, x


def pca_inputs(n_feat):
    rng = np.random.RandomState(n_feat)
    X = rng.gamma(2.0, 2.0, (8, n_feat)).astype(np.float32)
    return X - X.mean(axis=0)


def noise_inputs():
    """Two members' white half-planes at 64^2, a filter, 6 levels of the
    Gaussian bank and std coefficients."""
    from pysteps_tpu_torch import cascade

    rng = np.random.RandomState(8)
    white = (rng.randn(2, 64, 33) + 1j * rng.randn(2, 64, 33)).astype(np.complex64) * 45.0
    white[:, :, 0] = (white[:, :, 0] + np.conj(np.roll(white[:, ::-1, 0], 1, axis=1))) / 2**0.5
    white[:, :, -1] = (white[:, :, -1] + np.conj(np.roll(white[:, ::-1, -1], 1, axis=1))) / 2**0.5
    ky = np.fft.fftfreq(64)[:, None]
    kx = np.fft.rfftfreq(64)[None, :]
    filt = (1.0 / (1e-2 + np.hypot(ky, kx))).astype(np.float32)
    w2d = np.asarray(cascade.get_method("gaussian")((64, 64), 6)["weights_2d"], np.float32)
    nsc = np.linspace(0.8, 1.2, 6).astype(np.float32)
    return white, filt, w2d, nsc


def enkf_inputs():
    """tests/test_torch_enkf.py's ``data``: 64^2 dB frames, the motion and a
    two-member NWP ensemble of 4 leads."""
    frames = make_synthetic_sequence(n_frames=9, shape=(64, 64), velocity=(2.0, 1.0), seed=1)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    velocity = np.zeros((2, 64, 64), np.float32)
    velocity[0], velocity[1] = 2.0, 1.0
    nwp = (db[2:9] + 0.5 * np.random.RandomState(7).randn(7, 64, 64)).astype(np.float32)
    return db.astype(np.float32)[1:3], np.stack([nwp[:4], nwp[:4] + 0.2]), velocity


ENKF_KW = dict(n_ens_members=4, precip_thr=-10.0, seed=42)


def masked_enkf_inputs():
    """tests/test_torch_enkf.py::test_masked_enkf_correct_step's ensembles
    (6 members at 32^2) and filter configuration."""
    rng = np.random.RandomState(11)
    bg = np.abs(rng.gamma(2.0, 2.0, (6, 32, 32))).astype(np.float32)
    obs = np.abs(rng.gamma(2.0, 2.5, (6, 32, 32))).astype(np.float32)
    bg[:3, :, 16:] = 0.0

    class Cfg:
        n_ens_members = 6
        precip_threshold = 0.5
        norain_threshold = 0.0

    return bg, obs, Cfg, {"n_lien": 3, "sampling_prob_source": "ensemble",
                          "iterative_prob_matching": False}


def masked_enkf_steps(mesh, steps=2):
    """Two corrections of ``masked_enkf_inputs`` by ``MaskedEnKF`` with
    ``mesh`` in its combination kwargs (None: unsharded)."""
    from pysteps_tpu_torch.blending.ens_kalman_filter_methods import MaskedEnKF

    bg, obs, Cfg, kw = masked_enkf_inputs()
    params = type("P", (), {"combination_kwargs": dict(kw, mesh=mesh)})()
    enkf = MaskedEnKF(Cfg(), params)
    outs = [_np(enkf.correct_step(torch.as_tensor(bg), torch.as_tensor(obs))[0])
            for _ in range(steps)]
    return np.stack(outs), np.array([enkf.sampling_probability])


def _raises(call, exc=ValueError):
    try:
        call()
    except exc:
        return np.array(True)
    return np.array(False)


def blending_checks(rank):
    """Every check of tests/test_torch_parallel_blending.py that needs
    several ranks; returns this rank's results (name -> array)."""
    import tempfile

    from pysteps_tpu_torch.blending import pca_ens_kalman_filter, steps
    from pysteps_tpu_torch.motion import vet
    from pysteps_tpu_torch.parallel import make_mesh, sharded_blending
    from pysteps_tpu_torch.parallel.mesh import all_gather_cat
    from pysteps_tpu_torch.utils import pca

    res = {}
    skill = tempfile.mkdtemp()
    meshes = {}
    for name, ((ens, y), _, _, _) in BLEND_CASES.items():
        mesh = meshes.setdefault((ens, y), make_mesh(ens=ens, y=y, device_type="cpu"))
        if mesh.get_coordinate() is not None:
            res[f"blend_{name}"] = _np(blend_case(name, skill, mesh))
    for name, r in BLEND_PLAIN.items():
        if rank == r:
            res[f"blend_{name}_plain"] = _np(blend_case(name, skill))
    # the halo of the 8-row blocks passes a block: the exchange gathers
    _, seed, shape, kw = BLEND_CASES["halo_1x4"]
    inputs = steps.scan_inputs(*blend_inputs(seed, shape), 2, 5, device="cpu",
                               outdir_path_skill=skill, **dict(BLEND_KW, **kw))
    st = inputs.statics
    res["halo_1x4_halo"] = np.array(sharded_blending._halo(
        2, inputs.vmax_bound, st["struct_radius"], st["mask_rim"], shape[0]))

    # the spatial route refuses what the JAX package refuses
    mesh_22, mesh_y4 = meshes[(2, 2)], meshes[(1, 4)]
    _, seed, shape, kw = BLEND_CASES["y_mean"]
    args = blend_inputs(seed, shape)
    from pysteps_tpu_torch import blending

    def spatial(args=args, **over):
        return blending.get_method("steps")(*args, 2, 5, mesh=mesh_22, device="cpu",
                                            outdir_path_skill=skill,
                                            **dict(BLEND_KW, **dict(kw, **over)))

    res["err_members"] = _raises(lambda: spatial(n_ens_members=3))
    res["err_rows"] = _raises(lambda: blending.get_method("steps")(
        *blend_inputs(seed, (30, 64)), 2, 5, mesh=mesh_y4, device="cpu",
        outdir_path_skill=skill, **dict(BLEND_KW, **kw)))
    res["err_external"] = _raises(lambda: spatial(
        precip_nowcast=np.repeat(args[0][-1:], 4, axis=0)[:, None].repeat(2, axis=1),
        nowcasting_method="external_nowcast"))
    inputs = steps.scan_inputs(*args, 2, 5, device="cpu", outdir_path_skill=skill,
                               **dict(BLEND_KW, **kw))
    res["err_chunked"] = _raises(lambda: sharded_blending.blending_scan_sharded(
        inputs.params, inputs.state, 2, mesh_22, members=slice(0, 2), **inputs.statics))

    # the noise normalization on 4 row shards (its columns)
    white, filt, w2d, nsc = noise_inputs()
    c_loc = 9  # the 33 columns padded to 36
    col0 = mesh_y4.get_local_rank("y") * c_loc

    def cols(a):
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (36 - 33,), a.dtype)], axis=-1)
        return torch.as_tensor(a[..., col0 : col0 + c_loc])

    from pysteps_tpu_torch.parallel.dist_fft import spec_weight_local

    levels, mu, sd = sharded_blending._noise_levels(
        cols(white), cols(filt), cols(w2d), spec_weight_local(64, 4, mesh_y4),
        torch.as_tensor(nsc), (64, 64), col0, mesh_y4)
    res["noise_levels"] = _np(all_gather_cat(levels, mesh_y4, "y", dim=-2))
    res["noise_mu"], res["noise_sd"] = _np(mu), _np(sd)

    # the PCA fit on 4 ranks, over "y" and (padded) over "ens"
    for name, ((ens, y), n_feat) in PCA_CASES.items():
        mesh = meshes.get((ens, y)) or make_mesh(ens=ens, y=y, device_type="cpu")
        vt, var = pca._fit_pca_sharded(torch.as_tensor(pca_inputs(n_feat)), mesh)
        res[f"pca_{name}_vt"], res[f"pca_{name}_var"] = _np(vt), _np(var)

    # the masked EnKF's corrections with the mesh, and the PCA EnKF
    res["masked_enkf"], res["masked_enkf_prob"] = masked_enkf_steps(mesh_y4)
    obs, nwp_ens, velocity = enkf_inputs()
    res["pca_enkf"] = _np(pca_ens_kalman_filter.forecast(
        obs, None, nwp_ens, None, velocity, 3, device="cpu", mesh=mesh_y4, **ENKF_KW))
    if rank == 0:
        res["pca_enkf_plain"] = _np(pca_ens_kalman_filter.forecast(
            obs, None, nwp_ens, None, velocity, 3, device="cpu", **ENKF_KW))

    # VET's sharded cost at one sector displacement, and VET on 4 row shards
    tmpl, trg, mask, x = vet_cost_inputs()
    cost = vet._make_cost_sharded(
        torch.as_tensor(tmpl), torch.as_tensor(trg), torch.as_tensor(mask), VET_SMOOTH,
        VET_SECTORS, vet._interp_matrices(64, 64, *VET_SECTORS, "cpu"), mesh_y4)
    value, grad = cost(torch.as_tensor(x))
    res["vet_cost_value"], res["vet_cost_grad"] = _np(value), _np(grad)
    res["vet_flow"] = _np(vet.vet(vet_inputs(), mesh=mesh_y4, device="cpu", **VET_KW))
    return res


def _entry(rank, target, world, pg_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_path}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        res = target(rank)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_group(target, tmp_dir, world=WORLD, timeout=600):
    """Run ``target(rank)`` on ``world`` spawned gloo ranks; returns the
    list of each rank's saved results.  Fails (and stops every rank) when
    a rank fails or the deadline passes."""
    tmp_dir = str(tmp_dir)
    ctx = mp.start_processes(
        _entry, args=(target, world, os.path.join(tmp_dir, "pg"), tmp_dir),
        nprocs=world, start_method="spawn", join=False,
    )
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.time() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = []
    for r in range(world):
        with np.load(os.path.join(tmp_dir, f"rank{r}.npz")) as f:
            out.append(dict(f))
    return out
