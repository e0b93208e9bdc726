"""Semi-Lagrangian backward advection of the STEPS scan (counterpart of
``pysteps_tpu/extrapolation/semilagrangian.py``).

Displacements are (..., 2, m, n) with the x component first; any leading
batch axes (members) are carried through.  With a static displacement
bound ``max_disp`` the velocity sampling and the field warp run through
kernels K1 (``ops/pallas_warp.py::axis_resample``) and K2
(``ops/pallas_warp.py::warp_fused``); without one, through the exact
bilinear gather.  ``extrapolate`` is the public lead loop (a Python loop
where the JAX package has a ``lax.scan``); ``semilag_step`` one
incremental step.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.ops.pallas_warp import warp_fused
from pysteps_tpu_torch.ops.warp import (
    bilinear_upsample,
    bilinear_warp,
    block_mean,
    sample_velocity_shifted,
    warp,
    warp_shifted,
    warp_shifted_multi,
)


def _sample_velocity(velocity, displacement):
    """Edge-clamped bilinear sample of the (..., 2, m, n) velocity at
    positions displaced by ``displacement``."""
    m, n = velocity.shape[-2:]
    yy = torch.arange(m, dtype=velocity.dtype, device=velocity.device)[:, None]
    xx = torch.arange(n, dtype=velocity.dtype, device=velocity.device)[None, :]
    cy = yy + displacement[..., 1, :, :]
    cx = xx + displacement[..., 0, :, :]
    vx = bilinear_warp(velocity[..., 0, :, :], cy, cx, mode="nearest")
    vy = bilinear_warp(velocity[..., 1, :, :], cy, cx, mode="nearest")
    return torch.stack([vx, vy], dim=-3)


def _midpoint(sample, displacement, td, n_iter, vel_timestep):
    """Midpoint rule with ``n_iter`` inner iterations; ``sample(d)`` is the
    velocity at displacement d."""
    scale = td / vel_timestep
    if n_iter <= 0:
        return displacement - sample(displacement) * scale
    vel_inc = sample(displacement) * scale / n_iter
    for it in range(n_iter):
        vel_inc = sample(displacement - vel_inc / 2.0) * scale / n_iter
        displacement = displacement - vel_inc
        if it + 1 < n_iter:
            vel_inc = sample(displacement) * scale / n_iter
    return displacement


def integrate_displacement(
    velocity, displacement, td, n_iter=1, vel_timestep=1.0, max_disp=None
):
    """Advance the accumulated backward displacement by one interval
    ``td`` (midpoint rule).  With ``max_disp`` the velocity sampling takes
    the shift-decomposition path (K1 on a 4x coarsened grid)."""
    if max_disp is not None:
        def sample(d):
            return sample_velocity_shifted(velocity, d, max_disp)
    else:
        def sample(d):
            return _sample_velocity(velocity, d)
    return _midpoint(sample, displacement, td, n_iter, vel_timestep)


def coarsen_velocity(velocity, coarse=4):
    """Block-average a (..., 2, m, n) velocity for coarse-grid integration
    (values stay in full-resolution pixel units)."""
    if coarse <= 1:
        return velocity
    return block_mean(velocity, coarse)


def integrate_displacement_coarse(
    vel_c, disp_c, td, n_iter=1, vel_timestep=1.0, max_disp=None, coarse=4
):
    """Midpoint integration on the coarse grid: ``disp_c`` (..., 2, mc, nc)
    is in full-resolution pixel units at coarse positions, ``vel_c`` from
    :func:`coarsen_velocity`.  Each velocity sample is two K1 launches
    (both axes) over all members and both velocity channels."""
    if coarse <= 1:
        return integrate_displacement(
            vel_c, disp_c, td, n_iter=n_iter, vel_timestep=vel_timestep,
            max_disp=max_disp,
        )
    Dc = max(int(-(-(max_disp or coarse) // coarse)), 1)

    def sample(d):
        return warp_shifted_multi(vel_c, d / coarse, Dc, mode="nearest")

    return _midpoint(sample, disp_c, td, n_iter, vel_timestep)


def upsample_displacement(disp_c, shape, coarse=4):
    """Bilinear upsample of a coarse (..., 2, mc, nc) displacement."""
    if coarse <= 1:
        return disp_c
    return bilinear_upsample(disp_c, shape)


def upsample_planes(disp_c, shape, coarse):
    """The planes K2 consumes: ``dy`` (..., m, n) and the transposed
    (dx, dy) pair ``disp_t`` (..., 2, n, m), both contiguous."""
    up = upsample_displacement(disp_c, shape, coarse)
    return up[..., 1, :, :].contiguous(), up.transpose(-1, -2).contiguous()


def model_warp(field, displacement, max_disp=None, interp_order=1, cval=float("nan")):
    """Shift-decomposition warp (K1) with a static bound, exact gather
    otherwise."""
    if max_disp is not None and interp_order == 1:
        return warp_shifted(field, displacement, max_disp, cval=cval)
    return warp(field, displacement, order=interp_order, cval=cval)


def model_warp_coarse(
    field, disp_c, shape, coarse, max_disp=None, interp_order=1, cval=float("nan")
):
    """Upsample a coarse displacement and warp the (B, m, n) ``field``:
    through K2 with in-kernel coordinates when a static bound is given and
    the grid is a multiple of 8, else upsample + :func:`model_warp`."""
    m, n = shape
    if (
        max_disp is not None
        and interp_order == 1
        and coarse > 1
        and m % 8 == 0
        and n % 8 == 0
    ):
        dy, disp_t = upsample_planes(disp_c, shape, coarse)
        return warp_fused(field.contiguous(), dy, disp_t, int(max_disp), cval)
    return model_warp(
        field,
        upsample_displacement(disp_c, shape, coarse),
        max_disp=max_disp,
        interp_order=interp_order,
        cval=cval,
    )


def semilag_step(
    field,
    velocity,
    displacement,
    td=1.0,
    n_iter=1,
    vel_timestep=1.0,
    interp_order=1,
    outval=float("nan"),
):
    """One incremental semi-Lagrangian step: integrate the displacement
    over ``td`` and warp ``field`` along it (exact gather).  Returns
    (warped, displacement)."""
    displacement = integrate_displacement(
        velocity, displacement, td, n_iter=n_iter, vel_timestep=vel_timestep
    )
    warped = warp(field, displacement, order=interp_order, cval=outval)
    return warped, displacement


def _extrapolate_core(
    field, velocity, timestep_diffs, n_iter, interp_order, outval,
    displacement_init, vel_timestep, max_disp=None,
):
    """The lead loop: one displacement step and one warp of ``field`` per
    entry of ``timestep_diffs``.  Returns ((T, m, n) fields, the last
    displacement)."""
    displacement = displacement_init
    fields = []
    for td in timestep_diffs:
        displacement = integrate_displacement(
            velocity, displacement, td, n_iter=n_iter,
            vel_timestep=vel_timestep, max_disp=max_disp,
        )
        fields.append(
            model_warp(
                field, displacement, max_disp=max_disp,
                interp_order=interp_order, cval=outval,
            )
        )
    return torch.stack(fields), displacement


def extrapolate(
    precip,
    velocity,
    timesteps,
    outval=np.nan,
    xy_coords=None,
    allow_nonfinite_values=False,
    vel_timestep=1,
    device=None,
    **kwargs,
):
    """Semi-Lagrangian extrapolation with the JAX package's signature plus
    ``device`` (CUDA unless the caller asks for the CPU or passes CPU
    tensors).

    ``timesteps``: an int (that many unit steps) or an ascending list of
    lead times.  Other kwargs: ``displacement_prev``, ``n_iter``,
    ``return_displacement``, ``interp_order`` (0, 1 or 3).  On the card,
    bilinear on a grid of at least 144 pixels a side, the displacement
    and the warp take the shift decomposition with the static bound 48
    (kernel K1); elsewhere the exact gather.  Returns (T, m, n) fields
    and, with ``return_displacement``, the (2, m, n) displacement."""
    del xy_coords, allow_nonfinite_values  # grid in pixels; NaN propagates
    displacement_prev = kwargs.get("displacement_prev", None)
    n_iter = kwargs.get("n_iter", 1)
    return_displacement = kwargs.get("return_displacement", False)
    interp_order = kwargs.get("interp_order", 1)

    if interp_order not in (0, 1, 3):
        raise NotImplementedError("interp_order must be 0, 1 or 3")
    if precip is None and not return_displacement:
        raise ValueError("precip is None but return_displacement is False")
    device = resolve_device(device, precip, velocity, displacement_prev)
    velocity = torch.as_tensor(velocity, dtype=torch.float32, device=device)

    if isinstance(timesteps, int):
        timestep_list = np.arange(1, timesteps + 1, dtype=np.float64)
        vel_timestep = 1.0
    else:
        timestep_list = np.asarray(timesteps, dtype=np.float64)
        if np.any(np.diff(timestep_list) <= 0.0):
            raise ValueError("the timestep sequence is not monotonically increasing")
    # float32 intervals and velocity time step, as the JAX scan sees them
    timestep_diffs = np.hstack([[timestep_list[0]], np.diff(timestep_list)]).astype(
        np.float32
    )

    if precip is not None:
        precip = torch.as_tensor(precip, dtype=torch.float32, device=device)
        if isinstance(outval, str) and outval == "min":
            outval = float(torch.where(torch.isnan(precip), float("inf"), precip).min())
    else:
        outval = np.nan

    if displacement_prev is not None:
        displacement_init = torch.as_tensor(
            displacement_prev, dtype=torch.float32, device=device
        )
    else:
        displacement_init = torch.zeros_like(velocity)

    field = precip if precip is not None else torch.zeros(
        velocity.shape[1:], dtype=torch.float32, device=device
    )
    # the JAX package's static bound on accelerators, keyed here on the
    # field's device: the card takes K1, the CPU the exact gather
    m, n = velocity.shape[1:]
    max_disp = (
        48
        if device.type == "cuda" and int(interp_order) == 1 and min(m, n) >= 3 * 48
        else None
    )
    fields, displacement = _extrapolate_core(
        field, velocity, [float(td) for td in timestep_diffs], int(n_iter),
        int(interp_order), float(np.float32(outval)), displacement_init,
        float(np.float32(vel_timestep)), max_disp,
    )
    if precip is None:
        return None, displacement
    if return_displacement:
        return fields, displacement
    return fields
