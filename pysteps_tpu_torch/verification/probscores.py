"""Probabilistic scores: CRPS, the reliability diagram and the ROC curve
(counterpart of ``pysteps_tpu/verification/probscores.py``).  Each
accumulation reduces on the input's device; the states hold host floats
and numpy arrays, as the JAX module's do.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor


def _trapezoid(y, x):
    fn = getattr(np, "trapezoid", None) or np.trapz
    return fn(y, x=x)


def CRPS(X_f, X_o, device=None):
    """Continuous ranked probability score of an ensemble forecast
    ``X_f`` (n_members, ...) against ``X_o`` (...)."""
    crps = CRPS_init()
    CRPS_accum(crps, X_f, X_o, device=device)
    return CRPS_compute(crps)


def CRPS_init():
    """An empty CRPS state."""
    return {"CRPS_sum": 0.0, "n": 0.0}


def CRPS_accum(CRPS, X_f, X_o, device=None):
    """Add the CRPS of each pixel where every member and the observation
    are finite: E|X - obs| - E|X - X'| / 2, the pair term from the sorted
    members, sum_i (2i + 1 - n) x_(i) / n^2."""
    X_f = as_device_tensor(X_f, device, torch.float32)
    X_o = as_device_tensor(X_o, X_f.device if device is None else device, torch.float32)
    n_members = X_f.shape[0]
    flat_f = X_f.reshape(n_members, -1).T  # (N, members)
    flat_o = X_o.reshape(-1)
    valid = torch.all(torch.isfinite(flat_f), dim=1) & torch.isfinite(flat_o)

    fsort, _ = torch.sort(flat_f, dim=1)
    obs = flat_o[:, None]
    term1 = torch.mean(torch.abs(flat_f - obs), dim=1)
    idx = torch.arange(n_members, device=X_f.device)
    pair = torch.sum((2 * idx + 1 - n_members) * fsort, dim=1) / (n_members * n_members)
    crps_pix = term1 - pair
    CRPS["CRPS_sum"] += float(torch.sum(torch.where(valid, crps_pix, 0.0)))
    CRPS["n"] += float(torch.sum(valid))


def CRPS_merge(CRPS_1, CRPS_2):
    """The state of both states' pixels."""
    return {
        "CRPS_sum": CRPS_1["CRPS_sum"] + CRPS_2["CRPS_sum"],
        "n": CRPS_1["n"] + CRPS_2["n"],
    }


def CRPS_compute(CRPS):
    """The mean CRPS."""
    return 1.0 * CRPS["CRPS_sum"] / max(CRPS["n"], 1.0)


def _finite_pairs(P_f, X_o, device):
    P_f = as_device_tensor(P_f, device).reshape(-1)
    X_o = as_device_tensor(X_o, P_f.device if device is None else device).reshape(-1)
    valid = torch.isfinite(P_f) & torch.isfinite(X_o)
    return P_f[valid], X_o[valid]


def reldiag(P_f, X_o, X_min, n_bins=10, min_count=10, device=None):
    """One-shot reliability diagram: (observed frequencies, forecast
    probabilities) of the bins with at least ``min_count`` samples."""
    rd = reldiag_init(X_min, n_bins=n_bins, min_count=min_count)
    reldiag_accum(rd, P_f, X_o, device=device)
    return reldiag_compute(rd)


def reldiag_init(X_min, n_bins=10, min_count=10):
    """An empty reliability-diagram state."""
    return {
        "X_min": X_min,
        "bin_edges": np.linspace(-1e-6, 1 + 1e-6, n_bins + 1),
        "n_bins": n_bins,
        "X_sum": np.zeros(n_bins),
        "Y_sum": np.zeros(n_bins, dtype=float),
        "num_idx": np.zeros(n_bins, dtype=float),
        "sample_size": np.zeros(n_bins, dtype=int),
        "min_count": min_count,
    }


def reldiag_accum(reldiag, P_f, X_o, device=None):
    """Add each finite pair to its probability bin (``np.digitize``'s
    rule, bins clipped to the ends)."""
    P_f, X_o = _finite_pairs(P_f, X_o, device)
    obs = (X_o >= reldiag["X_min"]).to(torch.float64)
    edges = torch.as_tensor(reldiag["bin_edges"], dtype=torch.float64, device=P_f.device)
    n_bins = reldiag["n_bins"]
    which_bin = torch.bucketize(P_f.to(torch.float64), edges, right=True) - 1
    which_bin = torch.clamp(which_bin, 0, n_bins - 1)
    x_sum = torch.zeros(n_bins, dtype=torch.float64, device=P_f.device)
    x_sum.index_add_(0, which_bin, P_f.to(torch.float64))
    y_sum = torch.zeros_like(x_sum).index_add_(0, which_bin, obs)
    count = torch.bincount(which_bin, minlength=n_bins)
    reldiag["X_sum"] += x_sum.cpu().numpy()
    reldiag["Y_sum"] += y_sum.cpu().numpy()
    reldiag["num_idx"] += count.cpu().numpy()
    reldiag["sample_size"] += count.cpu().numpy().astype(int)


def reldiag_compute(reldiag):
    """(observed relative frequency, mean forecast probability) of the bins
    with at least ``min_count`` samples."""
    f = reldiag["X_sum"] / np.maximum(reldiag["num_idx"], 1)
    r = reldiag["Y_sum"] / np.maximum(reldiag["num_idx"], 1)
    mask = reldiag["sample_size"] >= reldiag["min_count"]
    return r[mask], f[mask]


def ROC_curve(P_f, X_o, X_min, n_prob_thrs=10, compute_area=False, device=None):
    """One-shot ROC curve: (POFD, POD[, area])."""
    roc = ROC_curve_init(X_min, n_prob_thrs=n_prob_thrs)
    ROC_curve_accum(roc, P_f, X_o, device=device)
    return ROC_curve_compute(roc, compute_area=compute_area)


def ROC_curve_init(X_min, n_prob_thrs=10):
    """An empty ROC state."""
    return {
        "X_min": X_min,
        "hits": np.zeros(n_prob_thrs, dtype=float),
        "misses": np.zeros(n_prob_thrs, dtype=float),
        "false_alarms": np.zeros(n_prob_thrs, dtype=float),
        "corr_neg": np.zeros(n_prob_thrs, dtype=float),
        "prob_thrs": np.linspace(0.0, 1.0, n_prob_thrs),
    }


def ROC_curve_accum(ROC, P_f, X_o, device=None):
    """Add the contingency counts of every probability threshold."""
    P_f, X_o = _finite_pairs(P_f, X_o, device)
    obs = X_o >= ROC["X_min"]
    thrs = torch.as_tensor(ROC["prob_thrs"], dtype=torch.float64, device=P_f.device)
    fore = P_f.to(torch.float64)[None, :] >= thrs[:, None]  # (thresholds, N)
    for key, count in (
            ("hits", fore & obs), ("misses", ~fore & obs),
            ("false_alarms", fore & ~obs), ("corr_neg", ~fore & ~obs)):
        ROC[key] += torch.sum(count, dim=1).cpu().numpy()


def ROC_curve_compute(ROC, compute_area=False):
    """(POFD, POD) at each threshold, and with ``compute_area`` the
    trapezoidal area under the curve."""
    POD = ROC["hits"] / np.maximum(ROC["hits"] + ROC["misses"], 1)
    POFD = ROC["false_alarms"] / np.maximum(ROC["false_alarms"] + ROC["corr_neg"], 1)
    if compute_area:
        x = np.concatenate([[1.0], POFD, [0.0]])[::-1]
        y = np.concatenate([[1.0], POD, [0.0]])[::-1]
        return POFD, POD, _trapezoid(y, x)
    return POFD, POD
