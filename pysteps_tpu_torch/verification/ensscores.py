"""Ensemble skill and spread and the rank histogram (counterpart of
``pysteps_tpu/verification/ensscores.py``).  The rank histogram reduces on
the input's device; its ties are broken at random from ``generator``
(PyTorch's default generator when None)."""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.verification.interface_helpers import resolve_det_score


def ensemble_skill(X_f, X_o, metric, device=None, **kwargs):
    """Mean score of the members of ``X_f`` against ``X_o``."""
    X_f = as_device_tensor(X_f, device)
    X_o = as_device_tensor(X_o, X_f.device)
    score = resolve_det_score(metric)
    return float(np.mean([score(X_f[i], X_o, **kwargs) for i in range(X_f.shape[0])]))


def ensemble_spread(X_f, metric, device=None, **kwargs):
    """Mean score of every pair of members against each other."""
    X_f = as_device_tensor(X_f, device)
    n = X_f.shape[0]
    score = resolve_det_score(metric)
    vals = [score(X_f[i], X_f[j], **kwargs) for i in range(n) for j in range(i + 1, n)]
    return float(np.mean(vals))


def rankhist(X_f, X_o, X_min=None, normalize=True, device=None, generator=None):
    """One-shot rank histogram of ``X_o`` among the members of ``X_f``."""
    rh = rankhist_init(X_f.shape[0], X_min=X_min)
    rankhist_accum(rh, X_f, X_o, device=device, generator=generator)
    return rankhist_compute(rh, normalize=normalize)


def rankhist_init(num_ens_members, X_min=None):
    """An empty rank-histogram state."""
    return {
        "num_ens_members": num_ens_members,
        "n": np.zeros(num_ens_members + 1, dtype=float),
        "X_min": X_min,
    }


def rankhist_accum(rankhist, X_f, X_o, device=None, generator=None):
    """Add the rank of each valid observation: pixels with every member and
    the observation finite and, with ``X_min``, any of them at or above
    it; a tie among r values takes one of its r + 1 ranks at random."""
    X_f = as_device_tensor(X_f, device)
    X_o = as_device_tensor(X_o, X_f.device if device is None else device)
    num = rankhist["num_ens_members"]
    flat_f = X_f.reshape(num, -1).T
    flat_o = X_o.reshape(-1)
    valid = torch.all(torch.isfinite(flat_f), dim=1) & torch.isfinite(flat_o)
    if rankhist["X_min"] is not None:
        # exclude all-dry cases below the threshold
        wet = (flat_o >= rankhist["X_min"]) | torch.any(flat_f >= rankhist["X_min"], dim=1)
        valid &= wet
    flat_f, flat_o = flat_f[valid], flat_o[valid]
    ranks = torch.sum(flat_f < flat_o[:, None], dim=1)
    ties = torch.sum(flat_f == flat_o[:, None], dim=1)
    if bool(torch.any(ties > 0)):
        u = torch.rand(len(ranks), generator=generator, device=ranks.device,
                       dtype=torch.float64)
        ranks = ranks + (u * (ties + 1)).to(torch.int64)
    rankhist["n"] += torch.bincount(ranks, minlength=num + 1).cpu().numpy()


def rankhist_merge(rankhist_1, rankhist_2):
    """The histogram of both states' cases."""
    out = dict(rankhist_1)
    out["n"] = rankhist_1["n"] + rankhist_2["n"]
    return out


def rankhist_compute(rankhist, normalize=True):
    """The counts, or their relative frequencies with ``normalize``."""
    if normalize:
        return rankhist["n"] / max(rankhist["n"].sum(), 1.0)
    return rankhist["n"]
