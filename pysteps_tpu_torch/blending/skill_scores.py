"""
Blending skill scores (counterpart of
``pysteps_tpu/blending/skill_scores.py``).

Per-cascade-level NWP-vs-radar correlations (on the cascades' device; only
the k correlations come back to the host) and their lead-time-dependent
decay towards climatology (BPS2004 eq. 24, host numpy).
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.blending import clim


def spatial_correlation(obs, mod, domain_mask, device=None):
    """Per-cascade-level correlation (k,) between the radar and model
    cascades (k, m, n) over the radar domain, as host numpy (reference:
    skill_scores.py:22).  Runs on ``obs``'s device (numpy input on the
    card unless ``device`` says otherwise)."""
    obs = as_device_tensor(obs, device)
    mod = as_device_tensor(mod, obs.device, obs.dtype)
    domain_mask = as_device_tensor(domain_mask, obs.device, torch.bool)
    valid = ~domain_mask & torch.isfinite(obs).all(dim=0) & torch.isfinite(mod).all(dim=0)
    w = valid.to(obs.dtype)
    cnt = torch.clamp(w.sum(), min=1.0)
    mo = (obs * w).sum(dim=(-2, -1), keepdim=True) / cnt
    mm = (mod * w).sum(dim=(-2, -1), keepdim=True) / cnt
    cov = ((mod - mm) * (obs - mo) * w).sum(dim=(-2, -1))
    so = torch.sqrt(((obs - mo) ** 2 * w).sum(dim=(-2, -1)))
    sm = torch.sqrt(((mod - mm) ** 2 * w).sum(dim=(-2, -1)))
    rho = cov / torch.clamp(so * sm, min=1e-12)
    return np.nan_to_num(rho.cpu().numpy(), nan=10e-5, posinf=10e-5, neginf=10e-5)


def lt_dependent_cor_nwp(lt, correlations, outdir_path, n_model=0, skill_kwargs=None):
    """NWP skill at lead time lt: regression towards climatology
    (reference: skill_scores.py:81; BPS2004 eq. 24)."""
    skill_kwargs = skill_kwargs or {}
    clim_cor_values, regr_pars = clim_regr_values(
        n_cascade_levels=len(correlations),
        outdir_path=outdir_path,
        n_model=n_model,
        skill_kwargs=skill_kwargs,
    )
    qm = np.exp(-lt / regr_pars[0, :]) * (2 - np.exp(-lt / regr_pars[1, :]))
    return qm * np.asarray(correlations) + (1 - qm) * clim_cor_values


def lt_dependent_cor_extrapolation(PHI, correlations=None, correlations_prev=None, ar_order=2):
    """Extrapolation-component skill decay through the AR process
    (reference: skill_scores.py:139)."""
    PHI = np.asarray(PHI)
    if correlations_prev is None:
        correlations_prev = np.repeat(1.0, PHI.shape[0])
    if ar_order == 1:
        if correlations is None:
            correlations = PHI[:, 0]
        rho = PHI[:, 0] * correlations
    elif ar_order == 2:
        if correlations is None:
            correlations = PHI[:, 0] / (1.0 - PHI[:, 1])
        rho = PHI[:, 0] * correlations + PHI[:, 1] * correlations_prev
    else:
        raise ValueError("ar_order must be 1 or 2")
    return rho, correlations


def clim_regr_values(n_cascade_levels, outdir_path, n_model=0, skill_kwargs=None):
    """Climatological correlations + hard-coded BPS2004 regression
    parameters (reference: skill_scores.py:201)."""
    skill_kwargs = dict(skill_kwargs or {"n_models": 1})
    skill_kwargs.setdefault("n_models", 1)
    try:
        clim_cor_values = clim.calc_clim_skill(
            outdir_path=outdir_path, n_cascade_levels=n_cascade_levels, **skill_kwargs
        )
    except FileNotFoundError:
        clim_cor_values = clim.get_default_skill(
            n_cascade_levels=n_cascade_levels, n_models=skill_kwargs["n_models"]
        )
    clim_cor_values = clim_cor_values[n_model, :]
    if clim_cor_values.shape[0] > n_cascade_levels:
        clim_cor_values = clim_cor_values[:n_cascade_levels]
    elif clim_cor_values.shape[0] < n_cascade_levels:
        clim_cor_values = np.append(
            clim_cor_values,
            np.repeat(1e-4, n_cascade_levels - clim_cor_values.shape[0]),
        )

    regr_pars = np.array(
        [
            [130.0, 165.0, 120.0, 55.0, 50.0, 15.0, 15.0, 10.0],
            [155.0, 220.0, 200.0, 75.0, 10e4, 10e4, 10e4, 10e4],
        ]
    )
    if regr_pars.shape[1] > n_cascade_levels:
        regr_pars = regr_pars[:, :n_cascade_levels]
    elif regr_pars.shape[1] < n_cascade_levels:
        extra = n_cascade_levels - regr_pars.shape[1]
        regr_pars = np.append(
            regr_pars, [np.repeat(10.0, extra), np.repeat(10e4, extra)], axis=1
        )
    return clim_cor_values, regr_pars
