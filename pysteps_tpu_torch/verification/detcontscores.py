"""Deterministic continuous scores (counterpart of
``pysteps_tpu/verification/detcontscores.py``), one-shot and streaming
(init / accum / merge / compute with Chan et al.'s parallel merges of
means, variances and covariances).  Reductions run in float32 on the
input's device; the streaming state holds host floats.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor


def _pair(pred, obs, device):
    pred = as_device_tensor(pred, device, torch.float32)
    obs = as_device_tensor(obs, pred.device if device is None else device, torch.float32)
    return pred, obs


def _valid(pred, obs, conditioning, thr):
    valid = torch.isfinite(pred) & torch.isfinite(obs)
    if conditioning == "single":
        valid &= (obs > thr) | (pred > thr)
    elif conditioning == "double":
        valid &= (obs > thr) & (pred > thr)
    return valid


def _pick(result, scores):
    if isinstance(scores, str):
        wanted = [s.strip() for s in scores.split(",")] if scores else []
    else:
        wanted = list(scores)
    if not wanted or wanted == [""]:
        return result
    lower = [s.lower() for s in wanted]
    picked = {k: v for k, v in result.items() if k.lower() in lower}
    if len(picked) == 1:
        return list(picked.values())[0]
    return picked


def det_cont_fct(pred, obs, scores="", axis=None, conditioning=None, thr=0.0, device=None):
    """One-shot continuous scores of ``pred`` against ``obs`` over the
    pixels where both are finite (and, with ``conditioning`` "single" or
    "double", either or both above ``thr``): one value for one score,
    else a dict."""
    pred, obs = _pair(pred, obs, device)
    valid = _valid(pred, obs, conditioning, thr)
    w = valid.to(torch.float32)
    cnt = torch.clamp(torch.sum(w), min=1.0)
    err = torch.where(valid, pred - obs, 0.0)
    obs_v = torch.where(valid, obs, 0.0)
    pred_v = torch.where(valid, pred, 0.0)

    me = torch.sum(err) / cnt
    mae = torch.sum(torch.abs(err)) / cnt
    mse = torch.sum(err**2) / cnt
    obs_mean = torch.sum(obs_v) / cnt
    pred_mean = torch.sum(pred_v) / cnt
    obs_var = torch.sum(torch.where(valid, (obs - obs_mean) ** 2, 0.0)) / cnt
    pred_var = torch.sum(torch.where(valid, (pred - pred_mean) ** 2, 0.0)) / cnt
    cov = torch.sum(torch.where(valid, (obs - obs_mean) * (pred - pred_mean), 0.0)) / cnt

    result = {
        "ME": me,
        "MAE": mae,
        "MSE": mse,
        "RMSE": torch.sqrt(mse),
        "NMSE": mse / torch.clamp((obs_mean + pred_mean) ** 2 / 4.0, min=1e-12),
        "DRMSE": torch.sqrt(mse) / torch.clamp(obs_mean, min=1e-12),
        "beta1": cov / torch.clamp(obs_var, min=1e-12),
        "beta2": cov / torch.clamp(pred_var, min=1e-12),
        "corr_p": cov / torch.clamp(torch.sqrt(obs_var * pred_var), min=1e-12),
        "corr_s": _spearman(pred, obs, valid),
        "RV": 1.0 - mse / torch.clamp(obs_var, min=1e-12),
        "scatter": _scatter(pred, obs, valid),
    }
    result = {k: float(v) for k, v in result.items()}
    return _pick(result, scores)


def _ranks(x):
    order = torch.argsort(x, stable=True)
    r = torch.empty_like(order)
    r[order] = torch.arange(x.numel(), device=x.device)
    return r.to(torch.float32)


def _spearman(pred, obs, valid):
    """Rank correlation over the valid samples (invalid entries pushed to
    the end, cancelling in the weighted moments)."""
    p = torch.where(valid, pred, float("inf")).reshape(-1)
    o = torch.where(valid, obs, float("inf")).reshape(-1)
    rp, ro = _ranks(p), _ranks(o)
    w = valid.reshape(-1).to(torch.float32)
    cnt = torch.clamp(torch.sum(w), min=1.0)
    mp = torch.sum(rp * w) / cnt
    mo = torch.sum(ro * w) / cnt
    cov = torch.sum((rp - mp) * (ro - mo) * w)
    vp = torch.sum((rp - mp) ** 2 * w)
    vo = torch.sum((ro - mo) ** 2 * w)
    return cov / torch.clamp(torch.sqrt(vp * vo), min=1e-12)


def _nanquantile(x, q):
    """Linear-interpolation quantile of the non-NaN entries of ``x``
    (NaN if there are none), by one sort: no size limit."""
    s, _ = torch.sort(x.reshape(-1))  # NaN sort last
    n = int(torch.sum(~torch.isnan(s)))
    if n == 0:
        return torch.tensor(float("nan"), device=x.device)
    pos = q * (n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return s[lo] + (s[hi] - s[lo]) * frac


def _scatter(pred, obs, valid):
    """Half the distance between the 16% and 84% quantiles of the error
    ratio in dB."""
    ratio = torch.where(
        valid & (obs > 0) & (pred > 0), 10.0 * torch.log10(pred / obs), float("nan")
    )
    return (_nanquantile(ratio, 0.84) - _nanquantile(ratio, 0.16)) / 2.0


def det_cont_fct_init(axis=None, conditioning=None, thr=0.0):
    """An empty streaming state."""
    return {
        "cov": 0.0, "vobs": 0.0, "vpred": 0.0, "mobs": 0.0, "mpred": 0.0,
        "me": 0.0, "mae": 0.0, "mse": 0.0, "n": 0.0,
        "conditioning": conditioning, "thr": thr,
    }


def det_cont_fct_accum(err, pred, obs, device=None):
    """Merge one batch's moments into ``err`` (Chan's parallel merge)."""
    pred, obs = _pair(pred, obs, device)
    valid = _valid(pred, obs, err["conditioning"], err["thr"])
    n_b = float(torch.sum(valid))
    if n_b == 0:
        return
    w = valid.to(torch.float32)
    mobs_b = float(torch.sum(obs * w) / n_b)
    mpred_b = float(torch.sum(pred * w) / n_b)
    vobs_b = float(torch.sum((obs - mobs_b) ** 2 * w) / n_b)
    vpred_b = float(torch.sum((pred - mpred_b) ** 2 * w) / n_b)
    cov_b = float(torch.sum((obs - mobs_b) * (pred - mpred_b) * w) / n_b)
    e = torch.where(valid, pred - obs, 0.0)
    me_b = float(torch.sum(e) / n_b)
    mae_b = float(torch.sum(torch.abs(e)) / n_b)
    mse_b = float(torch.sum(e**2) / n_b)

    n_a = err["n"]
    n = n_a + n_b
    if n_a == 0:
        err.update(
            mobs=mobs_b, mpred=mpred_b, vobs=vobs_b, vpred=vpred_b,
            cov=cov_b, me=me_b, mae=mae_b, mse=mse_b, n=n_b,
        )
        return
    d_obs = mobs_b - err["mobs"]
    d_pred = mpred_b - err["mpred"]
    err["vobs"] = (n_a * err["vobs"] + n_b * vobs_b) / n + d_obs**2 * n_a * n_b / n**2
    err["vpred"] = (n_a * err["vpred"] + n_b * vpred_b) / n + d_pred**2 * n_a * n_b / n**2
    err["cov"] = (n_a * err["cov"] + n_b * cov_b) / n + d_obs * d_pred * n_a * n_b / n**2
    err["mobs"] += d_obs * n_b / n
    err["mpred"] += d_pred * n_b / n
    err["me"] += (me_b - err["me"]) * n_b / n
    err["mae"] += (mae_b - err["mae"]) * n_b / n
    err["mse"] += (mse_b - err["mse"]) * n_b / n
    err["n"] = n


def det_cont_fct_merge(err_1, err_2):
    """The state of both states' samples."""
    out = dict(err_1)
    n_a, n_b = err_1["n"], err_2["n"]
    if n_b == 0:
        return out
    if n_a == 0:
        return dict(err_2)
    n = n_a + n_b
    d_obs = err_2["mobs"] - err_1["mobs"]
    d_pred = err_2["mpred"] - err_1["mpred"]
    out["vobs"] = (n_a * err_1["vobs"] + n_b * err_2["vobs"]) / n + d_obs**2 * n_a * n_b / n**2
    out["vpred"] = (
        n_a * err_1["vpred"] + n_b * err_2["vpred"]
    ) / n + d_pred**2 * n_a * n_b / n**2
    out["cov"] = (
        n_a * err_1["cov"] + n_b * err_2["cov"]
    ) / n + d_obs * d_pred * n_a * n_b / n**2
    for k in ("mobs", "mpred", "me", "mae", "mse"):
        out[k] = (n_a * err_1[k] + n_b * err_2[k]) / n
    out["n"] = n
    return out


def det_cont_fct_compute(err, scores=""):
    """The scores named in ``scores`` from an accumulated state."""
    result = {
        "ME": err["me"],
        "MAE": err["mae"],
        "MSE": err["mse"],
        "RMSE": np.sqrt(err["mse"]),
        "NMSE": err["mse"] / max((err["mobs"] + err["mpred"]) ** 2 / 4.0, 1e-12),
        "DRMSE": np.sqrt(err["mse"]) / max(err["mobs"], 1e-12),
        "beta1": err["cov"] / max(err["vobs"], 1e-12),
        "beta2": err["cov"] / max(err["vpred"], 1e-12),
        "corr_p": err["cov"] / max(np.sqrt(err["vobs"] * err["vpred"]), 1e-12),
        "RV": 1.0 - err["mse"] / max(err["vobs"], 1e-12),
    }
    return _pick(result, scores)
