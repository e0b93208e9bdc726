"""AR(p) parameter estimation (counterpart of the Yule-Walker path of
``pysteps_tpu/timeseries/autoregression.py``)."""

import numpy as np
import torch


def adjust_lag2_corrcoef2(gamma_1, gamma_2):
    """Stationarity clamp of the lag-2 coefficient; gamma_1 is clipped into
    (-1, 1) so that (1 - gamma_1^2)^1.5 stays real."""
    gamma_1 = torch.clamp(gamma_1, -0.9999, 0.9999)
    gamma_2 = torch.maximum(gamma_2, 2 * gamma_1 * gamma_2 - 1)
    gamma_2 = torch.maximum(
        gamma_2,
        (3 * gamma_1**2 - 2 + 2 * (1 - gamma_1**2) ** 1.5)
        / torch.clamp(gamma_1**2, min=1e-8),
    )
    return gamma_2


def estimate_ar_params_yw(gamma):
    """Yule-Walker AR(p) fit from lag autocorrelations ``gamma`` (..., p).
    Returns (..., p+1): phi_1..phi_p and the innovation coefficient
    sqrt(1 - sum gamma_j phi_j).  The stationarity check of the JAX
    package's ``check_stationarity=True`` is not ported: STEPS calls it
    with the check off."""
    # keep the Toeplitz system non-singular at |gamma| == 1
    gamma = torch.clamp(gamma, -0.9985, 0.9985)
    p = gamma.shape[-1]
    g = torch.cat([torch.ones_like(gamma[..., :1]), gamma], dim=-1)
    idx = torch.as_tensor(
        np.abs(np.subtract.outer(np.arange(p), np.arange(p))), device=gamma.device
    )
    G = g[..., idx]
    phi = torch.linalg.solve(G, gamma[..., None])[..., 0]
    c = 1.0 - torch.sum(gamma * phi, dim=-1)
    phi_pert = torch.sqrt(torch.clamp(c, min=0.0))
    return torch.cat([phi, phi_pert[..., None]], dim=-1)
