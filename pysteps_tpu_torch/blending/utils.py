"""
Blending helpers (counterpart of ``pysteps_tpu/blending/utils.py``).

The NWP cascade store is a compressed NPZ file, as in the JAX package
(the stored content, decomposed cascades, means, stds and valid times, is
that of pySTEPS' NetCDF store; no netCDF4 dependency).
"""

import os
import warnings

import numpy as np
import torch

from pysteps_tpu_torch import cascade as cascade_module
from pysteps_tpu_torch._device import as_device_tensor, device_of
from pysteps_tpu_torch.cascade.decomposition import decompose_core
from pysteps_tpu_torch.nowcasts.utils import _cross_dilate
from pysteps_tpu_torch.ops.conv import sep_corr


def stack_cascades(R_d, donorm=True, device=None):
    """Stack decomposed cascades (dicts with ``cascade_levels``, ``means``,
    ``stds``) into (levels, t, m, n) plus means and stds (levels, t); with
    ``donorm`` each level is normalized by its statistics."""
    R_c = torch.stack([as_device_tensor(R["cascade_levels"], device) for R in R_d], dim=1)
    mu = torch.stack([as_device_tensor(R["means"], R_c.device) for R in R_d], dim=1)
    sigma = torch.stack([as_device_tensor(R["stds"], R_c.device) for R in R_d], dim=1)
    if donorm:
        R_c = (R_c - mu[:, :, None, None]) / sigma[:, :, None, None]
    return R_c, mu, sigma


def blend_cascades(cascades_norm, weights, device=None):
    """Weighted blend of normalized cascades (components, k, m, n) or
    (components, k) with weights (components, k) over the components."""
    cascades_norm = as_device_tensor(cascades_norm, device)
    weights = as_device_tensor(weights, cascades_norm.device, cascades_norm.dtype)
    while weights.ndim < cascades_norm.ndim:
        weights = weights[..., None]
    return torch.sum(weights * cascades_norm, dim=0)


def recompose_cascade(combined_cascade, combined_mean, combined_sigma, device=None):
    """Recompose a blended (k, m, n) cascade with blended statistics (k,)."""
    combined_cascade = as_device_tensor(combined_cascade, device)
    dev = combined_cascade.device
    mean = as_device_tensor(combined_mean, dev, combined_cascade.dtype)
    sigma = as_device_tensor(combined_sigma, dev, combined_cascade.dtype)
    return torch.sum(
        combined_cascade * sigma[:, None, None] + mean[:, None, None], dim=0
    )


def blend_optical_flows(flows, weights, device=None):
    """Weight-combine (components, 2, m, n) advection fields."""
    if isinstance(flows, (list, tuple)):
        flows = torch.stack([as_device_tensor(f, device) for f in flows])
    else:
        flows = as_device_tensor(flows, device)
    weights = as_device_tensor(weights, flows.device, flows.dtype)
    if weights.shape[0] != flows.shape[0]:
        raise ValueError(
            "weights dimension must match the number of flows: "
            f"{flows.shape[0]} != {weights.shape[0]}"
        )
    weights = weights / weights.sum()
    return torch.sum(flows * weights[:, None, None, None], dim=0)


def decompose_NWP(
    R_NWP,
    NWP_model,
    analysis_time=None,
    timestep=None,
    valid_times=None,
    num_cascade_levels=6,
    num_workers=1,
    output_path=None,
    decomp_method="fft",
    fft_method="numpy",
    domain="spatial",
    normalize=True,
    compute_stats=True,
    compact_output=False,
    device=None,
):
    """Decompose a (T, m, n) NWP rainfall forecast into cascades on the
    device and store them as host numpy arrays: in an NPZ file under
    ``output_path`` (its path is returned) or, without one, as the
    returned dict (``cascade_levels``, ``means``, ``stds``,
    ``valid_times``)."""
    R_NWP = as_device_tensor(np.asarray(R_NWP, np.float32), device)
    T, m, n = R_NWP.shape
    bp_filter = cascade_module.get_method("gaussian")((m, n), num_cascade_levels)
    w2 = torch.tensor(np.asarray(bp_filter["weights_2d"]), dtype=torch.float32, device=R_NWP.device)
    levels, means, stds = decompose_core(R_NWP, w2, normalize=normalize)
    out = {
        "cascade_levels": levels.cpu().numpy(),
        "means": means.cpu().numpy(),
        "stds": stds.cpu().numpy(),
        "valid_times": np.asarray(valid_times if valid_times is not None else np.arange(T)),
    }
    if output_path is not None:
        os.makedirs(output_path, exist_ok=True)
        path = os.path.join(output_path, f"cascade_{NWP_model}_{analysis_time or 'latest'}.npz")
        np.savez_compressed(path, **out)
        return path
    return out


def compute_store_nwp_motion(
    precip_nwp, oflow_method, analysis_time=None, nwp_model="model", output_path=None
):
    """Per-step NWP motion fields (T, 2, m, n) from ``oflow_method`` on
    each consecutive pair, the last repeated; stored as an NPY file under
    ``output_path`` (its path is returned) or returned."""
    if isinstance(precip_nwp, torch.Tensor):
        precip_nwp = precip_nwp.detach().cpu().numpy()
    precip_nwp = np.asarray(precip_nwp)
    flows = []
    for t in range(precip_nwp.shape[0] - 1):
        flow = oflow_method(precip_nwp[t : t + 2])
        if isinstance(flow, torch.Tensor):
            flow = flow.detach().cpu().numpy()
        flows.append(np.asarray(flow))
    flows.append(flows[-1])
    flows = np.stack(flows)
    if output_path is not None:
        os.makedirs(output_path, exist_ok=True)
        path = os.path.join(output_path, f"motion_{nwp_model}_{analysis_time or 'latest'}.npy")
        np.save(path, flows)
        return path
    return flows


def load_NWP(input_nc_path_decomp, input_path_velocities, start_time=None, n_timesteps=None):
    """Load a stored NWP cascade and motion pair as host numpy arrays:
    (decomposition dict, velocities)."""
    data = np.load(input_nc_path_decomp)
    velocities = np.load(input_path_velocities)
    decomp = {
        "cascade_levels": data["cascade_levels"],
        "means": data["means"],
        "stds": data["stds"],
        "valid_times": data["valid_times"],
        "domain": "spatial",
        "normalized": True,
    }
    if n_timesteps is not None:
        decomp["cascade_levels"] = decomp["cascade_levels"][: n_timesteps + 1]
        decomp["means"] = decomp["means"][: n_timesteps + 1]
        decomp["stds"] = decomp["stds"][: n_timesteps + 1]
        velocities = velocities[: n_timesteps + 1]
    return decomp, velocities


def compute_smooth_dilated_mask(
    original_mask,
    max_padding_size_in_px=0,
    gaussian_kernel_size=9,
    inverted=False,
    non_linear_growth_kernel_sizes=False,
    device=None,
):
    """Smooth dilated (m, n) mask in [0, 1]: a Gaussian blur and threshold
    (OpenCV's default sigma for the kernel size), then the mean of graded
    diamond dilations (reference: blending/utils.py:561)."""
    if max_padding_size_in_px < 0:
        raise ValueError("max_padding_size_in_px must be >= 0")
    assert gaussian_kernel_size % 2

    dev = device_of(original_mask, device)
    mask = as_device_tensor(original_mask, dev).to(torch.bool)
    if inverted:
        mask = ~mask

    half = gaussian_kernel_size // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    sigma = 0.3 * ((gaussian_kernel_size - 1) * 0.5 - 1) + 0.8  # cv2 default
    k1 = torch.exp(-(x**2) / (2 * sigma**2))
    k1 = k1 / k1.sum()
    binary = sep_corr(mask.to(torch.float32), k1, k1) > 0.5

    if non_linear_growth_kernel_sizes:
        lin = np.linspace(0, np.sqrt(max_padding_size_in_px), 10)
        sizes = sorted(set((lin**2).astype(int)))
    else:
        sizes = sorted(set(np.linspace(0, max_padding_size_in_px, 10, dtype=int)))

    final = torch.zeros(binary.shape, dtype=torch.float32, device=dev)
    for size in sizes:
        dil = binary.to(torch.float32)[None]
        for _ in range(max(size // 2, 0)):
            dil = _cross_dilate(dil)
        final = final + (dil[0] > 0.5)
    return final / torch.clamp(final.max(), min=1.0)


def check_norain(precip_arr, precip_thr=None, norain_thr=0.0):
    """Deprecated alias for ``utils.check_norain.check_norain``."""
    from pysteps_tpu_torch.utils.check_norain import check_norain as _check_norain

    warnings.warn(
        "pysteps_tpu_torch.blending.utils.check_norain is deprecated; use "
        "pysteps_tpu_torch.utils.check_norain.check_norain instead",
        DeprecationWarning,
    )
    return _check_norain(precip_arr, precip_thr, norain_thr, None)
