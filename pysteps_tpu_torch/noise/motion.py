"""BPS velocity perturbation (counterpart of
``pysteps_tpu/noise/motion.py``; Bowler, Pierce & Seed 2006)."""

import math

import torch

from pysteps_tpu_torch._device import as_device_tensor


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


def initialize_bps(
    V, pixelsperkm, timestep, p_par=None, p_perp=None, randstate=None, seed=None,
    generator=None, device=None,
):
    """The BPS perturbator of a (2, m, n) motion field: one Laplace draw
    each along the flow and across it (from ``generator``, else one seeded
    with ``seed``), the unit flow and its perpendicular, on the field's
    device (the card unless the caller passes CPU tensors or
    ``device="cpu"``).  ``randstate`` is accepted for the JAX package's
    signature and ignored."""
    V = as_device_tensor(V, device).to(torch.float32)
    if V.ndim != 3 or V.shape[0] != 2:
        raise ValueError("V must have shape (2, m, n)")
    if p_par is None:
        p_par = get_default_params_bps_par()
    if p_perp is None:
        p_perp = get_default_params_bps_perp()
    if generator is None:
        generator = torch.Generator(device=V.device)
        generator.manual_seed(seed if seed is not None else 0)
    eps_par = _laplace(generator)
    eps_perp = _laplace(generator)
    N = torch.linalg.vector_norm(V, dim=0)
    V_n = torch.where(N[None] > 1e-12, V / torch.clamp(N[None], min=1e-12), 0.0)
    return {
        "vsf": 60.0 / (timestep * pixelsperkm),  # pixel/timestep -> km/h
        "p_par": tuple(float(p) for p in p_par),
        "p_perp": tuple(float(p) for p in p_perp),
        "eps_par": eps_par,
        "eps_perp": eps_perp,
        "V_par": V_n,
        "V_perp": torch.stack([-V_n[1], V_n[0]]),
    }


def generate_bps(perturbator, t):
    """The (2, m, n) velocity perturbation at lead time ``t`` minutes: the
    draws times (a t^b + c) / vsf along the parallel and perpendicular unit
    fields."""
    vsf = perturbator["vsf"]
    a1, b1, c1 = perturbator["p_par"]
    a2, b2, c2 = perturbator["p_perp"]
    g_par = a1 * t**b1 + c1
    g_perp = a2 * t**b2 + c2
    return (
        perturbator["eps_par"] * g_par * perturbator["V_par"]
        + perturbator["eps_perp"] * g_perp * perturbator["V_perp"]
    ) / vsf
