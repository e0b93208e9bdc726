"""STEPS blending's stochastic configurations in the PyTorch port against
the JAX package through the public ``forecast`` on the CPU, by the
``MODEL_PARITY.json`` recipe: CRPS against the synthetic truth and the
spread/error ratio, averaged over 2 seeds, within 10% of the JAX
package's (the two draw different random numbers from the same laws).
96^2, 12 members, 4 leads; the bench's configuration (nonparametric
noise, the resampled CDF target, the incremental mask), the parametric
filter with ``noise_stddev_adj="auto"``, and BPS velocity perturbation."""

import numpy as np
import pytest
import torch

from helpers import make_synthetic_sequence
from pysteps_tpu import blending as jblending
from pysteps_tpu_torch import blending as tblending

SIDE, E, T = 96, 12, 4
CASES = {
    "bench": {},
    "parametric_auto": dict(noise_method="parametric", noise_stddev_adj="auto"),
    "bps": dict(vel_pert_method="bps"),
}


def _crps(fc, obs):
    """The ensemble CRPS of (E, m, n) against (m, n), averaged over pixels."""
    fc = np.sort(fc, axis=0)
    n = fc.shape[0]
    term1 = np.mean(np.abs(fc - obs[None]), axis=0)
    w = (2 * np.arange(1, n + 1) - n - 1)[:, None, None]
    term2 = np.sum(w * fc, axis=0) / (n * n)
    return float(np.nanmean(term1 - term2))


def _scores(fc, truth):
    fc = np.asarray(fc, np.float64)
    crps = np.mean([_crps(fc[:, t], truth[t]) for t in range(fc.shape[1])])
    spread = np.nanmean(np.nanstd(fc, axis=0, ddof=1))
    err = np.sqrt(np.nanmean((np.nanmean(fc, axis=0) - truth) ** 2))
    return crps, spread / err


@pytest.mark.parametrize("case", list(CASES))
def test_stochastic_blending_crps_parity(case, tmp_path):
    frames = make_synthetic_sequence(n_frames=3 + T, shape=(SIDE, SIDE), velocity=(2.0, 1.0),
                                     seed=1, evolution=0.2)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    db = db.astype(np.float32)
    velocity = np.zeros((2, SIDE, SIDE), np.float32)
    velocity[0], velocity[1] = 2.0, 1.0
    nwp = (db[2:] + 0.5 * np.random.RandomState(7).randn(T + 1, SIDE, SIDE)).astype(np.float32)
    truth = db[3:]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    j, t = [], []
    try:
        for seed in (11, 22):
            kw = dict(n_ens_members=E, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0,
                      seed=seed, outdir_path_skill=str(tmp_path), **CASES[case])
            args = (db[:3], nwp[None], velocity, velocity[None], T, 5)
            j.append(_scores(jblending.get_method("steps")(*args, **kw), truth))
            out = tblending.get_method("steps")(*args, device="cpu", **kw)
            assert tuple(out.shape) == (E, T, SIDE, SIDE)
            assert bool((out.std(dim=0).mean(dim=(1, 2)) > 0).all())
            t.append(_scores(out.numpy(), truth))
    finally:
        torch.set_num_threads(n)
    (c_j, r_j), (c_t, r_t) = np.mean(j, axis=0), np.mean(t, axis=0)
    assert abs(c_t - c_j) / c_j <= 0.1, (c_t, c_j)
    assert abs(r_t - r_j) / r_j <= 0.1, (r_t, r_j)
