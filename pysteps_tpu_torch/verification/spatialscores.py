"""Spatial verification: the fractions skill score (FSS) and the binary-MSE
intensity-scale decomposition (counterpart of
``pysteps_tpu/verification/spatialscores.py``).

The FSS fractions are box-filter correlations with the JAX package's SAME
padding ((k - 1) // 2 before, k // 2 after) through ``ops/conv.py`` in
IEEE float32; the intensity-scale score uses the same 2-D Haar transform
as the JAX module.  Reductions run on the input's device; the states hold
host floats and numpy arrays.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.ops.conv import corr_same


def _uniform_filter(field, size):
    k = torch.full((size, size), 1.0 / (size * size), dtype=torch.float32,
                   device=field.device)
    return corr_same(field.to(torch.float32), k)


def _indicators(X_f, X_o, thr, device):
    X_f = as_device_tensor(X_f, device)
    X_o = as_device_tensor(X_o, X_f.device if device is None else device)
    valid = torch.isfinite(X_f) & torch.isfinite(X_o)
    I_f = ((X_f >= thr) & valid).to(torch.float32)
    I_o = ((X_o >= thr) & valid).to(torch.float32)
    return I_f, I_o, valid


def fss(X_f, X_o, thr, scale, device=None):
    """One-shot fractions skill score at threshold ``thr`` and window
    ``scale``."""
    state = fss_init(thr, scale)
    fss_accum(state, X_f, X_o, device=device)
    return fss_compute(state)


def fss_init(thr, scale):
    """An empty FSS state."""
    return {"thr": thr, "scale": int(scale), "sum_obs_sq": 0.0,
            "sum_fct_obs": 0.0, "sum_fct_sq": 0.0}


def fss_accum(fss, X_f, X_o, device=None):
    """Add one forecast/observation pair's fraction sums."""
    I_f, I_o, _ = _indicators(X_f, X_o, fss["thr"], device)
    if fss["scale"] > 1:
        S_f = _uniform_filter(I_f, fss["scale"])
        S_o = _uniform_filter(I_o, fss["scale"])
    else:
        S_f, S_o = I_f, I_o
    fss["sum_obs_sq"] += float(torch.sum(S_o**2))
    fss["sum_fct_obs"] += float(torch.sum(S_f * S_o))
    fss["sum_fct_sq"] += float(torch.sum(S_f**2))


def fss_merge(fss_1, fss_2):
    """The state of both states' pairs."""
    out = dict(fss_1)
    for k in ("sum_obs_sq", "sum_fct_obs", "sum_fct_sq"):
        out[k] = fss_1[k] + fss_2[k]
    return out


def fss_compute(fss):
    """The FSS of the accumulated sums."""
    numer = fss["sum_fct_sq"] - 2.0 * fss["sum_fct_obs"] + fss["sum_obs_sq"]
    denom = fss["sum_fct_sq"] + fss["sum_obs_sq"]
    return 1.0 - numer / max(denom, 1e-12)


def _haar_decomp(field, n_levels):
    """2-D Haar multiresolution: the detail field of each scale, then the
    last approximation."""
    details = []
    approx = field.to(torch.float32)
    for _ in range(n_levels):
        a = (
            approx[0::2, 0::2] + approx[0::2, 1::2]
            + approx[1::2, 0::2] + approx[1::2, 1::2]
        ) / 4.0
        up = torch.repeat_interleave(torch.repeat_interleave(a, 2, dim=0), 2, dim=1)
        details.append(approx - up)
        approx = a
    details.append(approx)
    return details


def binary_mse(X_f, X_o, thr, wavelet="haar", return_scales=True, device=None):
    """Binary-MSE skill score of each scale (and the scales)."""
    state = binary_mse_init(thr)
    binary_mse_accum(state, X_f, X_o, device=device)
    return binary_mse_compute(state, return_scales)


def binary_mse_init(thr, wavelet="haar"):
    """An empty binary-MSE state."""
    return {"thr": thr, "mse": None, "eps": None, "n": 0}


def binary_mse_accum(bmse, X_f, X_o, device=None):
    """Add one pair's per-scale MSE of the indicator difference and its
    observed base rate."""
    I_f, I_o, valid = _indicators(X_f, X_o, bmse["thr"], device)
    n_levels = int(np.log2(min(I_f.shape)))
    E_d = _haar_decomp(I_f - I_o, n_levels)
    mse = torch.stack([torch.mean(d**2) for d in E_d[:-1]]).cpu().numpy().astype(float)
    n_valid = int(torch.sum(valid))
    eps = float(torch.sum(I_o) / n_valid) if n_valid else 0.0
    if bmse["mse"] is None:
        bmse["mse"] = mse
        bmse["eps"] = eps
    else:
        bmse["mse"] = bmse["mse"] + mse
        bmse["eps"] += eps
    bmse["n"] += 1


def binary_mse_merge(bmse_1, bmse_2):
    """The state of both states' pairs."""
    out = dict(bmse_1)
    out["mse"] = bmse_1["mse"] + bmse_2["mse"]
    out["eps"] = bmse_1["eps"] + bmse_2["eps"]
    out["n"] = bmse_1["n"] + bmse_2["n"]
    return out


def binary_mse_compute(bmse, return_scales=True):
    """Skill score SS = 1 - MSE / MSE_random of each scale."""
    n = max(bmse["n"], 1)
    mse = bmse["mse"] / n
    eps = bmse["eps"] / n
    mse_random = 2.0 * eps * (1 - eps) / (len(mse))
    SS = 1.0 - mse / max(mse_random, 1e-12)
    if return_scales:
        scales = 2 ** np.arange(1, len(mse) + 1)
        return SS, scales
    return SS


def intensity_scale_init(name, thrs, scales=None, wavelet="haar"):
    """A streaming intensity-scale state: one FSS state per (threshold,
    scale) for "fss", one binary-MSE state per threshold for "bmse"."""
    name = name.lower()
    thrs = np.atleast_1d(np.asarray(thrs, float))
    if name == "fss":
        if scales is None:
            raise ValueError("FSS needs the scales argument")
        scales = np.atleast_1d(np.asarray(scales, int))
        states = {
            float(thr): {int(s): fss_init(float(thr), int(s)) for s in scales}
            for thr in thrs
        }
    elif name == "bmse":
        scales = None  # determined by the wavelet decomposition depth
        states = {float(thr): binary_mse_init(float(thr), wavelet) for thr in thrs}
    else:
        raise ValueError(f"unknown intensity-scale score {name}")
    return {"name": name, "thrs": thrs, "scales": scales, "states": states}


def intensity_scale_accum(intscale, X_f, X_o, device=None):
    """Add one forecast/observation pair to every (threshold, scale)."""
    for thr in intscale["thrs"]:
        state = intscale["states"][float(thr)]
        if intscale["name"] == "fss":
            for s in intscale["scales"]:
                fss_accum(state[int(s)], X_f, X_o, device=device)
        else:
            binary_mse_accum(state, X_f, X_o, device=device)
    if intscale["scales"] is None:
        # bmse: the scale count is known after the first accumulation
        first = intscale["states"][float(intscale["thrs"][0])]
        intscale["scales"] = 2 ** np.arange(1, len(first["mse"]) + 1)


def intensity_scale_merge(intscale_1, intscale_2):
    """The state of both states' pairs."""
    if intscale_1["name"] != intscale_2["name"]:
        raise ValueError(
            "cannot merge intensity-scale objects of different methods: "
            f"{intscale_1['name']} != {intscale_2['name']}"
        )
    out = {
        "name": intscale_1["name"],
        "thrs": intscale_1["thrs"],
        "scales": intscale_1["scales"],
        "states": {},
    }
    for thr in out["thrs"]:
        s1 = intscale_1["states"][float(thr)]
        s2 = intscale_2["states"][float(thr)]
        if out["name"] == "fss":
            out["states"][float(thr)] = {
                int(s): fss_merge(s1[int(s)], s2[int(s)]) for s in out["scales"]
            }
        else:
            out["states"][float(thr)] = binary_mse_merge(s1, s2)
    return out


def intensity_scale_compute(intscale):
    """The (n_scales, n_thrs) skill matrix of an accumulated state."""
    thrs = intscale["thrs"]
    scales = intscale["scales"]
    SS = np.zeros((len(scales), len(thrs)))
    for k, thr in enumerate(thrs):
        state = intscale["states"][float(thr)]
        if intscale["name"] == "fss":
            for j, s in enumerate(scales):
                SS[j, k] = fss_compute(state[int(s)])
        else:
            SS[:, k] = binary_mse_compute(state, return_scales=False)
    return SS


def intensity_scale(X_f, X_o, name, thrs, scales=None, wavelet="haar", device=None):
    """The (n_scales, n_thrs) skill matrix of one pair."""
    out = []
    for thr in np.atleast_1d(thrs):
        if name.lower() == "fss":
            row = [fss(X_f, X_o, thr, s, device=device) for s in scales]
        elif name.lower() == "bmse":
            row, scales = binary_mse(X_f, X_o, thr, device=device)
        else:
            raise ValueError(f"unknown intensity-scale score {name}")
        out.append(np.asarray(row))
    return np.stack(out).T
