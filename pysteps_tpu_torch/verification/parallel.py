"""
Mesh-distributed streaming verification (counterpart of
``pysteps_tpu/verification/parallel.py``).

The streaming scores (init / accum / merge / compute) merge associatively
across cases, so the case axis shards over a mesh dimension: each rank
accumulates its block of cases and one ``all_reduce`` sums the sufficient
statistics.  The returned states are exactly the serial ones, so the
serial ``*_compute`` functions apply unchanged.  Contingency counts are
reduced as int64; the CRPS and FSS sums in float64.
"""

import torch

from pysteps_tpu_torch.parallel.mesh import AXES, all_reduce, member_block, mesh_device
from pysteps_tpu_torch.verification import detcatscores, probscores, spatialscores


def _local_cases(cases, mesh, axis_name):
    """This rank's block of the case axis of a global (C, ...) array."""
    if axis_name not in AXES:
        raise ValueError(f"mesh has no axis {axis_name}")
    x = torch.as_tensor(cases, device=mesh_device(mesh)).to(torch.float32)
    start, stop = member_block(x.shape[0], mesh, axis_name)
    return x[start:stop]


def sharded_det_cat_accum(pred_cases, obs_cases, thr, mesh, axis_name="ens"):
    """Contingency-table accumulation over a case axis sharded on the mesh.

    pred_cases, obs_cases: (C, m, n) stacks with C divisible by the mesh
    dimension's size.  Returns the table a serial ``det_cat_fct_accum`` /
    ``det_cat_fct_merge`` chain gives (reference: detcatscores.py:133-265),
    with int64 counts."""
    pred = _local_cases(pred_cases, mesh, axis_name)
    obs = _local_cases(obs_cases, mesh, axis_name)
    valid = torch.isfinite(pred) & torch.isfinite(obs)
    predb = (pred > thr) & valid
    obsb = (obs > thr) & valid
    local = torch.stack([
        torch.sum(predb & obsb),
        torch.sum(predb & ~obsb & valid),
        torch.sum(~predb & obsb & valid),
        torch.sum(~predb & ~obsb & valid),
    ]).to(torch.int64)
    h, f, m_, r = all_reduce(local, mesh, axis_name)
    return {
        "hits": h, "false_alarms": f, "misses": m_, "correct_negatives": r,
        "thr": thr, "axis": None,
    }


def sharded_crps_accum(ens_cases, obs_cases, mesh, axis_name="ens"):
    """CRPS sufficient statistics over sharded cases.

    ens_cases: (C, n_members, m, n); obs_cases: (C, m, n).  Returns the
    serial CRPS state (reference: probscores.py:77-134)."""
    ens = _local_cases(ens_cases, mesh, axis_name)
    obs = _local_cases(obs_cases, mesh, axis_name)
    c, n_members = ens.shape[0], ens.shape[1]
    flat_f = ens.reshape(c, n_members, -1)
    flat_o = obs.reshape(c, -1)
    valid = torch.all(torch.isfinite(flat_f), dim=1) & torch.isfinite(flat_o)
    fsort = torch.sort(flat_f, dim=1).values
    term1 = torch.mean(torch.abs(flat_f - flat_o[:, None]), dim=1)
    idx = torch.arange(n_members, device=ens.device)
    pair = torch.sum((2 * idx + 1 - n_members)[None, :, None] * fsort, dim=1) / (
        n_members * n_members)
    crps_pix = term1 - pair
    local = torch.stack([
        torch.sum(torch.where(valid, crps_pix, 0.0)).double(),
        torch.sum(valid).double(),
    ])
    s, n = all_reduce(local, mesh, axis_name)
    return {"CRPS_sum": float(s), "n": float(n)}


def sharded_fss_accum(pred_cases, obs_cases, thr, scale, mesh, axis_name="ens"):
    """FSS sufficient statistics over sharded cases.

    pred_cases, obs_cases: (C, m, n).  Returns the serial FSS state
    (reference: spatialscores.py:549-657)."""
    scale = int(scale)
    pred = _local_cases(pred_cases, mesh, axis_name)
    obs = _local_cases(obs_cases, mesh, axis_name)
    valid = torch.isfinite(pred) & torch.isfinite(obs)
    I_f = ((pred >= thr) & valid).to(torch.float32)
    I_o = ((obs >= thr) & valid).to(torch.float32)
    if scale > 1:
        S_f = spatialscores._uniform_filter(I_f, scale)
        S_o = spatialscores._uniform_filter(I_o, scale)
    else:
        S_f, S_o = I_f, I_o
    local = torch.stack([
        torch.sum(S_o**2), torch.sum(S_f * S_o), torch.sum(S_f**2)
    ]).double()
    so, fo, sf = all_reduce(local, mesh, axis_name)
    return {
        "thr": thr, "scale": scale, "sum_obs_sq": float(so),
        "sum_fct_obs": float(fo), "sum_fct_sq": float(sf),
    }


def distributed_verify(score, mesh, axis_name="ens", **kwargs):
    """Name -> (sharded_accum, compute) pair: ``sharded_accum(*cases)``
    returns the serial state, ``compute`` is the unchanged serial one."""
    table = {
        "det_cat": (
            lambda p, o: sharded_det_cat_accum(p, o, kwargs["thr"], mesh, axis_name),
            detcatscores.det_cat_fct_compute,
        ),
        "CRPS": (
            lambda e, o: sharded_crps_accum(e, o, mesh, axis_name),
            probscores.CRPS_compute,
        ),
        "FSS": (
            lambda p, o: sharded_fss_accum(
                p, o, kwargs["thr"], kwargs["scale"], mesh, axis_name
            ),
            spatialscores.fss_compute,
        ),
    }
    if score not in table:
        raise ValueError(f"unknown distributed score {score}; available: {list(table)}")
    return table[score]
