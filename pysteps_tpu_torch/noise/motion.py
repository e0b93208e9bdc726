"""BPS velocity perturbation draws (counterpart of
``pysteps_tpu/noise/motion.py``)."""

import math

import torch


def get_default_params_bps_par():
    """Parallel-component (a, b, c) defaults of Bowler, Pierce & Seed 2006."""
    return (10.88, 0.23, -7.68)


def get_default_params_bps_perp():
    """Perpendicular-component (a, b, c) defaults."""
    return (5.76, 0.31, -2.72)


def _laplace(generator, shape=()):
    """Laplace(scale = 1/sqrt(2)) draws by the inverse CDF of
    U(-0.5 + 1e-7, 0.5 - 1e-7) from ``generator``."""
    lo, hi = -0.5 + 1e-7, 0.5 - 1e-7
    u = torch.rand(shape, generator=generator, device=generator.device) * (hi - lo) + lo
    return -torch.sign(u) * torch.log(1.0 - 2.0 * torch.abs(u)) / math.sqrt(2.0)
