"""Blending on the card against the same functions on the CPU, at 128^2

- STEPS blending, deterministic (no noise, no resampling of the target):
  the card takes the shift path (its bound from the blended velocity, K1
  on the coarse displacement and the composite, K4 from a mask at init
  and every lead: exactly 3 K1 launches an axis and 1 rim a lead); the
  CPU is given the same bound (``extrap_kwargs["max_disp"]``) and runs the
  plain versions.  The exact CDF match at the end swaps the ranks of
  pixels within rounding of each other, so the outputs are held with
  identical NaN sets at 99.9% of their pixels within 1e-3 x span and on
  average within 1e-4 x span;
- the member chunks: chunks of 2 on the card equal one chunk within the
  same tolerance, and the bfloat16 output is the float32 one rounded;
- the noise and resampled-target draws on the card: the members spread
  at every lead;
- one PCA EnKF cycle (the correction and the nowcast step on the shift
  path, bound 48) from one state on both devices: the analysis within
  1e-3 of its largest value, the matched and warped members as above;
- the forecast from CUDA tensors equals the forecast from host numpy
  inputs, and the init's no-rain gate costs one host sync (counted by the
  benchmark's span reduction);
- linear and salient blending over the extrapolation nowcast at 160^2:
  the card's K1 path against the CPU's exact gather within 1e-4 x span
  (salient: at 99.9% of the pixels, the dense ranks of values within
  rounding may swap).

The checks themselves are ``tests/torch_blending_checks.py``'s, which
``chip_smoke.py`` runs at the bench's sizes.  Every test needs a CUDA card
and skips without one.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_blending_cuda.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch_blending_checks as checks  # noqa: E402
from benchmark.harness import spans, trace  # noqa: E402
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu_torch import blending  # noqa: E402
from pysteps_tpu_torch.ops import _kernels  # noqa: E402

pytestmark = pytest.mark.cuda

SIDE, E, T = 128, 6, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def skill_dir(tmp_path):
    return str(tmp_path)


def _inputs(side=SIDE):
    frames = make_synthetic_sequence(n_frames=4, shape=(side, side), velocity=(1.7, 0.6),
                                     seed=42, evolution=0.2)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    db = db.astype(np.float32)
    vel = np.zeros((2, side, side), np.float32)
    vel[0], vel[1] = 1.7, 0.6
    nwp = (np.repeat(db[2][None], T + 1, axis=0)
           + 0.3 * np.random.RandomState(1).randn(T + 1, side, side)).astype(np.float32)
    return db[:3], nwp[None], vel


def _det_kw(skill_dir, **extra):
    return dict(dict(n_ens_members=E, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0,
                     seed=1, noise_method=None, resample_distribution=False,
                     outdir_path_skill=skill_dir), **extra)


def test_steps_blending_card_branch_against_cpu(dev, skill_dir):
    db, nwp, vel = _inputs()
    checks.steps_card_vs_cpu("steps blending", db, nwp, vel, T, _det_kw(skill_dir))


def test_member_chunks_and_bfloat16_on_the_card(dev, skill_dir):
    db, nwp, vel = _inputs()
    checks.chunk_check("member chunks", db, nwp, vel, T, _det_kw(skill_dir))


def test_stochastic_blending_spreads_on_the_card(dev, skill_dir):
    db, nwp, vel = _inputs()
    out = blending.get_method("steps")(
        db, nwp, vel, vel[None], T, 5.0,
        **_det_kw(skill_dir, noise_method="nonparametric", resample_distribution=True))
    assert out.is_cuda and bool(torch.isfinite(out).all())
    assert bool((out.std(dim=0).mean(dim=(1, 2)) > 0).all())


def _card_inputs(dev):
    db, nwp, vel = _inputs()
    return [torch.as_tensor(a, device=dev) for a in (db, nwp, vel, vel[None])]


def test_forecast_from_card_tensors_equals_host_inputs(dev, skill_dir):
    """The init takes the caller's CUDA tensors as they are and host
    arrays across once: the same forecast, bit for bit."""
    db, nwp, vel = _inputs()
    kw = _det_kw(skill_dir, noise_method="nonparametric", resample_distribution=True,
                 vel_pert_method="bps")
    f = blending.get_method("steps")
    host = f(db, nwp, vel, vel[None], T, 5.0, **kw)
    card = f(*_card_inputs(dev), T, 5.0, **kw)
    assert host.is_cuda and torch.equal(host, card)


def test_norain_gate_reads_the_card_once(dev, skill_dir):
    """From CUDA tensors nothing crosses in ``pst.init.norain``: its one
    host sync is the read of both gates' counts and the radar's minimum."""
    args, f = _card_inputs(dev), blending.get_method("steps")
    f(*args, T, 5.0, **_det_kw(skill_dir))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            with torch.profiler.record_function(trace.FORECAST_SPAN):
                f(*args, T, 5.0, **_det_kw(skill_dir))
            torch.cuda.synchronize()
    red = spans.reduce(prof.profiler.kineto_results.events())
    assert red["span_n"]["pst.init.norain"] == 1
    assert red["syncs"].get("pst.init/pst.init.norain") == 1, red["syncs"]


def test_pca_enkf_cycle_on_the_card_against_cpu(dev):
    db, nwp, vel = _inputs()
    rng = np.random.RandomState(2)
    members = torch.as_tensor(np.stack([nwp[0, :3] + 0.5 * rng.randn(3, SIDE, SIDE)
                                        for _ in range(E)]).astype(np.float32))
    checks.enkf_card_vs_cpu("PCA EnKF cycle", members, vel, 6, 10)


@pytest.mark.parametrize("method", ["linear_blending", "salient_blending"])
def test_linear_blending_card_against_cpu(dev, method):
    # 160^2: the extrapolation nowcast takes its card branch (bound 48, K1)
    # from 144 px a side
    db, nwp, vel = _inputs(160)
    meta = {"transform": "dB", "unit": "mm/h", "threshold": -10.0, "zerovalue": -15.0}
    rr = (10.0 ** (nwp[0, 1:] / 10.0)).astype(np.float32)
    f = blending.get_method(method)
    _kernels.reset_launches()
    card = f(db[-1], meta, vel, T, 5.0, "extrapolation", precip_nwp=rr, start_blending=5.0,
             end_blending=15.0)
    assert card.is_cuda and _kernels.LAUNCHES["resample_axis0"] == 3 * T
    cpu = f(db[-1], meta, vel, T, 5.0, "extrapolation", precip_nwp=rr, start_blending=5.0,
            end_blending=15.0, device="cpu")
    if method == "linear_blending":
        checks.nanclose(method, card, cpu, 1e-4, frac=1.0, mean_rel=1e-5)
    else:
        # the saliency ranks the two fields' difference densely: values
        # within rounding of each other may take neighbouring ranks
        checks.nanclose(method, card, cpu, 1e-4, frac=0.999, mean_rel=1e-5)


def test_pca_enkf_forecast_on_the_card(dev):
    db, nwp, vel = _inputs()
    ens = np.stack([nwp[0], nwp[0] + 0.2])
    out = blending.get_method("pca_enkf")(db[1:3], None, ens, None, vel, T, n_ens_members=E,
                                          precip_thr=-10.0, seed=3)
    assert out.is_cuda and tuple(out.shape) == (E, T + 1, SIDE, SIDE)
    assert not bool(torch.isinf(out).any())
