"""Deterministic categorical scores from a 2 x 2 contingency table
(counterpart of ``pysteps_tpu/verification/detcatscores.py``).

Streaming protocol: ``det_cat_fct_init`` / ``accum`` / ``merge`` /
``compute``.  The accumulation reduces on the input's device and keeps the
counts there; merging adds them; the scores come back as host floats (or
numpy arrays when ``axis`` keeps dimensions).
"""

import torch

from pysteps_tpu_torch._device import as_device_tensor

_COUNTS = ("hits", "false_alarms", "misses", "correct_negatives")


def det_cat_fct(pred, obs, thr, scores="", axis=None, device=None):
    """One-shot scores of ``pred`` against ``obs`` at threshold ``thr``."""
    contab = det_cat_fct_init(thr, axis=axis)
    det_cat_fct_accum(contab, pred, obs, device=device)
    return det_cat_fct_compute(contab, scores)


def det_cat_fct_init(thr, axis=None):
    """An empty contingency table."""
    return {
        "hits": None,
        "false_alarms": None,
        "misses": None,
        "correct_negatives": None,
        "thr": thr,
        "axis": axis,
    }


def det_cat_fct_accum(contab, pred, obs, device=None):
    """Add the counts of ``pred`` against ``obs`` (pixels where either is
    not finite are left out) over ``axis`` (all axes when None)."""
    pred = as_device_tensor(pred, device)
    obs = as_device_tensor(obs, pred.device if device is None else device)
    axis = contab["axis"]
    if axis is None:
        axis = tuple(range(pred.ndim))
    thr = contab["thr"]
    valid = torch.isfinite(pred) & torch.isfinite(obs)
    predb = (pred > thr) & valid
    obsb = (obs > thr) & valid
    H = torch.sum(predb & obsb, dim=axis)
    F = torch.sum(predb & ~obsb & valid, dim=axis)
    M = torch.sum(~predb & obsb & valid, dim=axis)
    R = torch.sum(~predb & ~obsb & valid, dim=axis)
    for key, val in zip(_COUNTS, (H, F, M, R)):
        contab[key] = val if contab[key] is None else contab[key] + val


def det_cat_fct_merge(contab_1, contab_2):
    """The table of both tables' cases."""
    out = dict(contab_1)
    for key in _COUNTS:
        out[key] = contab_1[key] + contab_2[key]
    return out


def det_cat_fct_compute(contab, scores=""):
    """The scores named in ``scores`` (a comma-separated string or a list;
    "" for all): one value for one score, else a dict."""
    if isinstance(scores, str):
        scores = [s.strip() for s in scores.split(",")] if scores else [""]
    H, F, M, R = (torch.as_tensor(contab[k]).to(torch.float32) for k in _COUNTS)
    N = H + F + M + R

    result = {}
    for score in scores:
        s = score.lower()
        if s in ("pod", ""):
            result["POD"] = _f(H / (H + M))
        if s in ("far", ""):
            result["FAR"] = _f(F / (H + F))
        if s in ("fa", ""):
            result["FA"] = _f(F / (F + R))
        if s in ("acc", ""):
            result["ACC"] = _f((H + R) / N)
        if s in ("csi", ""):
            result["CSI"] = _f(H / (H + M + F))
        if s in ("bias", ""):
            result["BIAS"] = _f((H + F) / (H + M))
        if s in ("hss", ""):
            result["HSS"] = _f(
                2 * (H * R - F * M) / ((H + M) * (M + R) + (H + F) * (F + R))
            )
        if s in ("hk", ""):
            result["HK"] = _f(H / (H + M) - F / (F + R))
        if s in ("gss", "ets", ""):
            HR = (H + M) * (H + F) / N
            result["GSS" if s in ("gss", "") else "ETS"] = _f(
                (H - HR) / (H + M + F - HR)
            )
        if s in ("f1", ""):
            result["F1"] = _f(2 * H / (2 * H + F + M))
        if s in ("mcc", ""):
            result["MCC"] = _f(
                (H * R - F * M) / torch.sqrt((H + F) * (H + M) * (R + F) * (R + M))
            )
        if s in ("sedi", ""):
            hr = H / (H + M)
            fa = F / (F + R)
            result["SEDI"] = _f(
                (torch.log(fa) - torch.log(hr) + torch.log(1 - hr) - torch.log(1 - fa))
                / (torch.log(fa) + torch.log(hr) + torch.log(1 - hr) + torch.log(1 - fa))
            )
    if len(result) == 1:
        return list(result.values())[0]
    return result


def _f(x):
    x = x.cpu().numpy()
    return float(x) if x.ndim == 0 else x
