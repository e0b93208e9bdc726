"""Shared nowcast machinery (counterpart of ``pysteps_tpu/nowcasts/utils.py``):
masks, the no-rain exit, lead-time binning, the parameter tables, cascade
stacking and the host main loop of custom models.

The grayscale rim of the incremental mask goes through kernel K4
(``ops/pallas_dilate.py``); ``_cross_dilate`` / ``binary_dilation`` are
the max-pool formulation the JAX package runs on the CPU, kept as the
independent reference the tests hold K4 against.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pysteps_tpu_torch._device import resolve_device, to_numpy
from pysteps_tpu_torch.ops.pallas_dilate import dilated_rim, dilated_rim_from_field


def _cross_dilate(field):
    """One step of connectivity-1 (diamond) grayscale dilation of
    (B, m, n) as two 1-D max-pools."""
    x = field[:, None]
    vert = F.max_pool2d(x, (3, 1), stride=1, padding=(1, 0))
    horiz = F.max_pool2d(x, (1, 3), stride=1, padding=(0, 1))
    return torch.maximum(vert, horiz)[:, 0]


def binary_dilation(mask, radius):
    """Binary dilation of a (B, m, n) mask by a diamond of ``radius``."""
    out = mask.to(torch.float32)
    for _ in range(max(int(radius), 1)):
        out = _cross_dilate(out)
    return out > 0


def compute_dilated_mask(input_mask, kr, r):
    """Buffered rain mask of a (B, m, n) mask with a grayscale rim: kr
    binary dilations, then r accumulating ones (K4)."""
    return dilated_rim(input_mask, int(kr), int(r))


def compute_dilated_mask_from_field(field, thr, kr, r):
    """``compute_dilated_mask(field >= thr, kr, r)`` with the threshold
    fused into K4."""
    return dilated_rim_from_field(field, thr, int(kr), int(r))


def compute_percentile_mask(precip, pct):
    """True for pixels of (..., m, n) at or above the intensity whose
    exceedance fraction is ``pct``."""
    flat = torch.sort(precip.reshape(precip.shape[:-2] + (-1,)), dim=-1).values
    n = flat.shape[-1]
    i = torch.clamp(
        torch.round((1.0 - pct) * n).to(torch.int32) - 1, 0, n - 1
    ).long()
    thr = flat[..., i]
    return precip >= thr[..., None, None]


def stream_leads(out, n_leads, callback):
    """Hand the first ``n_leads`` leads of the (E, T, m, n) tensor ``out``
    to ``callback`` one lead at a time, as (E, m, n) host numpy arrays
    fetched from the device in one copy."""
    arr = to_numpy(out[:, :n_leads])
    for t in range(n_leads):
        callback(arr[:, t])


def interpolate_leads(out, subsel, axis):
    """The frames of the lead times ``subsel`` from the unit-step frames
    of ``out`` along ``axis``: integer leads as they are, fractional ones
    linearly between their two neighbouring steps."""
    frames = []
    for t_sub in subsel:
        if t_sub == int(t_sub):
            frames.append(out.select(axis, int(t_sub) - 1))
        else:
            t_int = int(np.ceil(t_sub))
            lo = out.select(axis, t_int - 2 if t_int >= 2 else 0)
            hi = out.select(axis, t_int - 1)
            w = t_sub - (t_int - 1)
            frames.append((1 - w) * lo + w * hi)
    return torch.stack(frames, dim=axis)


def dilation_kernel(mask_rim):
    """Diamond structuring element of radius ``mask_rim`` (at least 1)."""
    n = max(int(mask_rim), 1)
    yy, xx = np.mgrid[-n : n + 1, -n : n + 1]
    return (np.abs(yy) + np.abs(xx) <= n).astype(np.float32)


def stack_cascades(precip_decomp, n_levels, convert_to_full_arrays=False):
    """Stack per-time decompositions into a (k, t, m, n) window."""
    del convert_to_full_arrays
    levels = torch.stack([d["cascade_levels"] for d in precip_decomp], dim=1)
    return levels[:n_levels]


def zero_precipitation_forecast(
    n_ens_members, timesteps, precip, device, callback=None, return_output=True,
    measure_time=False, start_time_init=None,
):
    """All-minimum forecast (E, T, m, n) on ``device`` for the no-rain
    exit; the callback gets each lead's (E, m, n) frames as host numpy
    arrays, from one copy of the stack.  With ``measure_time`` the init
    seconds run from ``start_time_init``, a ``time.perf_counter()``."""
    print("No precipitation above the threshold found in the radar field")
    print("The resulting forecast will contain only zeros")
    single = n_ens_members is None
    n_ens = 1 if single else n_ens_members
    num = timesteps if isinstance(timesteps, int) else len(timesteps)
    zero_value = float(np.nanmin(precip))
    out = torch.full(
        (n_ens, num) + tuple(precip.shape[1:]), zero_value,
        dtype=torch.float32, device=device,
    )
    if callback is not None:
        stream_leads(out, num, callback)
    result = None
    if return_output:
        result = out[0] if single else out
    if measure_time:
        import time

        elapsed = time.perf_counter() - start_time_init if start_time_init else 0.0
        return result, elapsed, 0.0
    return result


def binned_timesteps(timesteps):
    """Bin irregular lead times into unit intervals: bin t holds the
    indices of the lead times in (t-1, t]."""
    timesteps = list(timesteps)
    if any(np.diff(timesteps) <= 0):
        raise ValueError("timesteps is not in ascending order")
    if any(t < 0 for t in timesteps):
        raise ValueError("negative timesteps are not allowed")
    num_bins = int(np.ceil(max(timesteps)))
    bins = [[] for _ in range(num_bins + 1)]
    for i, t in enumerate(timesteps):
        bins[int(np.ceil(t))].append(i)
    return bins


def create_timestep_range(timesteps):
    """(steps, original lead times or None, "int" or "list"): a count
    gives range(timesteps + 1); a list is binned into unit intervals with
    a leading 0 (:func:`binned_timesteps`)."""
    if isinstance(timesteps, int):
        return range(timesteps + 1), None, "int"
    original_timesteps = [0] + list(timesteps)
    return binned_timesteps(original_timesteps), original_timesteps, "list"


def print_ar_params(phi):
    """Print the AR parameter table of the cascade levels."""
    phi = to_numpy(phi)
    print("****************************************")
    print("* AR(p) parameters for cascade levels: *")
    print("****************************************")
    hdr = "| Level |" + "".join(
        f"   Phi-{k + 1}   |" for k in range(phi.shape[1] - 1)
    ) + "   Phi-0   |"
    print(hdr)
    print("-" * len(hdr))
    for i in range(phi.shape[0]):
        row = f"| {i + 1:5d} |" + "".join(f" {v: 8.6f} |" for v in phi[i])
        print(row)


def print_corrcoefs(gamma):
    """Print the lag correlation coefficients of the cascade levels."""
    gamma = to_numpy(gamma)
    print("************************************************")
    print("* Correlation coefficients for cascade levels: *")
    print("************************************************")
    for i in range(gamma.shape[0]):
        print(
            f"| Level {i + 1}: "
            + " ".join(f"gamma_{k + 1}={v: .6f}" for k, v in enumerate(gamma[i]))
        )


def nowcast_main_loop(
    precip,
    velocity,
    state,
    timesteps,
    extrap_method,
    func,
    extrap_kwargs=None,
    velocity_pert_gen=None,
    params=None,
    ensemble=False,
    num_ensemble_members=1,
    callback=None,
    return_output=True,
    num_workers=1,
    measure_time=False,
    device=None,
):
    """Host main loop for custom advection-based models: ``func(state,
    params)`` gives each unit step's field(s) and next state; fractional
    lead times interpolate between steps; each member keeps its own
    displacement chain, advanced through the extrapolator of
    ``extrap_method`` on ``device`` (CUDA unless the caller asks for the
    CPU or passes CPU tensors), with ``velocity_pert_gen[i](t)`` added to
    member i's velocity.  Frames reach ``callback`` and the output as host
    numpy arrays, as in the JAX package."""
    import time as _time

    from pysteps_tpu_torch import extrapolation as _extrap

    device = resolve_device(device, precip, velocity)
    extrap_kwargs = dict(extrap_kwargs or {})
    extrap_kwargs["device"] = device
    extrapolator = _extrap.get_method(extrap_method)

    if isinstance(timesteps, int):
        bins = [[t] for t in range(timesteps + 1)]
        timestep_type = "int"
        original_timesteps = None
    else:
        original_timesteps = list(timesteps)
        bins = binned_timesteps(original_timesteps)
        timestep_type = "list"

    state_cur = state
    precip_forecast_prev = None
    displacement = None
    t_prev = 0.0
    t_total = 0.0
    out = None
    start_total = _time.time()

    for t, subtimestep_idx in enumerate(bins):
        if timestep_type == "list":
            subtimesteps = [original_timesteps[i] for i in subtimestep_idx]
        else:
            subtimesteps = [t] if t > 0 else []

        if t > 0 or (timestep_type == "list" and subtimesteps):
            precip_forecast_new, state_new = func(state_cur, params)
        else:
            precip_forecast_new, state_new = None, state_cur

        if precip_forecast_new is not None:
            precip_forecast_new = to_numpy(precip_forecast_new)
            if not ensemble:
                precip_forecast_new = precip_forecast_new[np.newaxis]

        for t_sub in subtimesteps:
            if t_sub <= 0:
                continue
            frac = t_sub - int(t_sub)
            if frac > 0.0 and precip_forecast_prev is not None:
                field_ip = (
                    (1.0 - frac) * precip_forecast_prev
                    + frac * precip_forecast_new
                )
            else:
                field_ip = precip_forecast_new
            t_diff = t_sub - t_prev
            t_total += t_diff
            if displacement is None:
                displacement = [None] * field_ip.shape[0]
            if out is None and return_output:
                out = [[] for _ in range(field_ip.shape[0])]
            cur = []
            for i in range(field_ip.shape[0]):
                ek = dict(extrap_kwargs)
                ek["displacement_prev"] = displacement[i]
                ek["allow_nonfinite_values"] = bool(
                    np.any(~np.isfinite(field_ip[i]))
                )
                vel = velocity
                if velocity_pert_gen is not None:
                    vel = velocity + velocity_pert_gen[i](t_total)
                ep, displacement[i] = extrapolator(
                    field_ip[i], vel, [t_diff], return_displacement=True, **ek
                )
                cur.append(to_numpy(ep[0]))
                if return_output:
                    out[i].append(cur[-1])
            if callback is not None:
                callback(np.stack(cur))
            t_prev = t_sub

        if not subtimesteps and t > 0:
            # advance the displacement chains by one step
            t_diff = t + 1 - t_prev
            t_total += t_diff
            if displacement is None:
                displacement = [None] * (
                    precip_forecast_new.shape[0] if precip_forecast_new is not None else 1
                )
            for i in range(len(displacement)):
                ek = dict(extrap_kwargs)
                ek["displacement_prev"] = displacement[i]
                _, displacement[i] = extrapolator(
                    None, velocity, [t_diff], return_displacement=True, **ek
                )
            t_prev = t + 1

        if precip_forecast_new is not None:
            precip_forecast_prev = precip_forecast_new
        state_cur = state_new

    if return_output and out is not None:
        out = np.stack([np.stack(o) for o in out])
        if not ensemble:
            out = out[0]
    if measure_time:
        return out, _time.time() - start_total
    return out
