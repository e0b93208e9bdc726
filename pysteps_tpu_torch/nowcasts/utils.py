"""Masks and the no-rain exit of the STEPS scan (counterpart of
``pysteps_tpu/nowcasts/utils.py``).

The grayscale rim of the incremental mask goes through kernel K4
(``ops/pallas_dilate.py``); ``_cross_dilate`` / ``binary_dilation`` are
the max-pool formulation the JAX package runs on the CPU, kept as the
independent reference the tests hold K4 against.
"""

import numpy as np
import torch
import torch.nn.functional as F

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


def zero_precipitation_forecast(
    n_ens_members, timesteps, precip, device, callback=None, return_output=True,
    measure_time=False, start_time_init=None,
):
    """All-minimum forecast (E, T, m, n) on ``device`` for the no-rain
    exit."""
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
        for t in range(num):
            callback(out[:, t])
    result = None
    if return_output:
        result = out[0] if single else out
    if measure_time:
        import time

        elapsed = time.time() - start_time_init if start_time_init else 0.0
        return result, elapsed, 0.0
    return result
