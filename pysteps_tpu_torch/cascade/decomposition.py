"""FFT cascade decomposition and recomposition on ``torch.fft``
(counterpart of ``pysteps_tpu/cascade/decomposition.py``).

Two layers, as in the JAX package:

- the ``*_core`` functions, which the nowcasts call in their loops.  They
  take fields with any leading batch axes: ``(..., m, n)`` spatial,
  ``(..., m, n//2+1)`` spectral, and filter banks ``(k, m, n//2+1)``; the
  level axis is inserted just before the grid axes;
- ``decomposition_fft`` / ``recompose_fft``: the dict API of one field
  (keys ``cascade_levels``, ``means``, ``stds``, ``domain``,
  ``normalized``, ``compact_output``).
"""

import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.utils import spectral as spectral_utils


def _masked_moments(levels, mask):
    """Per-level mean and std of (..., k, m, n) over the grid, or over a
    boolean (m, n) ``mask``."""
    if mask is None:
        means = levels.mean(dim=(-2, -1))
        stds = levels.std(dim=(-2, -1), correction=0)
    else:
        w = mask.to(levels.dtype)
        cnt = torch.clamp(w.sum(), min=1.0)
        means = (levels * w).sum(dim=(-2, -1)) / cnt
        var = ((levels - means[..., None, None]) ** 2 * w).sum(dim=(-2, -1)) / cnt
        stds = torch.sqrt(var)
    return means, stds


def decompose_core(field, weights_2d, mask=None, normalize=True, subtract_mean=False):
    """Decompose (..., m, n) into levels (..., k, m, n).  Returns (levels,
    means (..., k), stds (..., k)); with ``normalize`` each level is
    standardized (statistics over ``mask`` if given).  ``subtract_mean``
    removes each field's mean first."""
    shape = field.shape[-2:]
    if subtract_mean:
        field = field - field.mean(dim=(-2, -1), keepdim=True)
    field_fft = torch.fft.rfft2(field)
    levels = torch.fft.irfft2(field_fft[..., None, :, :] * weights_2d, s=shape)
    means, stds = _masked_moments(levels, mask)
    if normalize:
        levels = (levels - means[..., None, None]) / torch.clamp(
            stds[..., None, None], min=1e-12
        )
    return levels, means, stds


def decompose_spectral_core(field_fft, weights_2d, shape, normalize=True):
    """Spectral-domain decomposition of rfft2 half-planes (..., m, n//2+1)
    into levels (..., k, m, n//2+1).  The mean acts on the DC bin only and
    the std comes from Parseval."""
    levels_fft = field_fft[..., None, :, :] * weights_2d
    means = spectral_utils.mean(levels_fft, shape)
    stds = spectral_utils.std(levels_fft, shape)
    if normalize:
        size = shape[0] * shape[1]
        dc = torch.zeros_like(levels_fft)
        dc[..., 0, 0] = (means * size).to(levels_fft.dtype)
        levels_fft = (levels_fft - dc) / torch.clamp(stds[..., None, None], min=1e-12)
    return levels_fft, means, stds


def spectral_level_stds(field_fft, weights_2d, shape):
    """Per-level means and stds of ``w_k * field_fft`` without forming the
    (..., k, m, n//2+1) levels: each level's Parseval power is the squared
    filter bank contracted against the field's power spectrum, with the
    half-plane's inner columns counted twice.  Equals
    :func:`decompose_spectral_core`'s statistics to rounding."""
    m, n = shape
    rf = n // 2 + 1
    size = m * n
    k = weights_2d.shape[0]
    herm = torch.full((rf,), 2.0, dtype=torch.float32, device=field_fft.device)
    herm[0] = 1.0
    if n % 2 == 0:
        herm[rf - 1] = 1.0
    p2 = (field_fft.real**2 + field_fft.imag**2) * herm
    s2 = p2.reshape(p2.shape[:-2] + (-1,)) @ (weights_2d.reshape(k, -1) ** 2).T
    means = field_fft[..., 0, 0].real[..., None] * weights_2d[:, 0, 0] / size
    stds = torch.sqrt(torch.clamp(s2 / float(size) ** 2 - means**2, min=0.0))
    return means, stds


def recompose_core(levels, means, stds):
    """sum_k (level_k * sigma_k + mu_k) over the level axis."""
    return torch.sum(levels * stds[..., None, None] + means[..., None, None], dim=-3)


def recompose_spectral_core(levels_fft, means, stds, shape):
    """Spectral recompose and inverse FFT to the spatial (..., m, n) field."""
    size = shape[0] * shape[1]
    out_fft = torch.sum(levels_fft * stds[..., None, None], dim=-3)
    dc = torch.zeros_like(out_fft)
    dc[..., 0, 0] = (torch.sum(means, dim=-1) * size).to(out_fft.dtype)
    return torch.fft.irfft2(out_fft + dc, s=tuple(shape))


def decomposition_fft(field, bp_filter, **kwargs):
    """Dict-API decomposition of one field with the filter bank of
    ``bp_filter`` (its ``weights_2d`` and ``shape``).

    kwargs: ``normalize`` (False), ``mask`` (statistics over a boolean
    mask; spatial output only), ``compute_stats`` (True), ``subtract_mean``
    (False), ``input_domain`` / ``output_domain`` ("spatial" or
    "spectral": rfft2 half-planes), ``compact_output`` (spectral output
    only: each level keeps the wavenumbers its filter weighs above 1e-12,
    as a 1-D tensor), ``device`` (where a field that is not a tensor
    goes: the card unless it says otherwise).  The levels lie on the
    field's device."""
    normalize = kwargs.get("normalize", False)
    mask = kwargs.get("mask", None)
    input_domain = kwargs.get("input_domain", "spatial")
    output_domain = kwargs.get("output_domain", "spatial")
    compute_stats = kwargs.get("compute_stats", True) or normalize
    subtract_mean = kwargs.get("subtract_mean", False)
    compact_output = kwargs.get("compact_output", False) and output_domain == "spectral"

    field = as_device_tensor(field, kwargs.get("device"))
    weights_2d = bp_filter["weights_2d"]
    if isinstance(weights_2d, torch.Tensor):
        weights_2d = weights_2d.to(device=field.device, dtype=torch.float32)
    else:  # the bandpass filters' cached (read-only) numpy banks
        weights_2d = torch.tensor(weights_2d, dtype=torch.float32, device=field.device)
    result = {"domain": output_domain, "normalized": normalize,
              "compact_output": compact_output}

    if output_domain == "spectral":
        if input_domain == "spatial":
            if subtract_mean:
                field_mean = field.mean()
                field = field - field_mean
                result["field_mean"] = field_mean
            field_fft = torch.fft.rfft2(field)
            shape = tuple(field.shape)
        else:
            field_fft = field
            shape = tuple(bp_filter["shape"])
        levels, means, stds = decompose_spectral_core(
            field_fft, weights_2d, shape, normalize=normalize
        )
    else:
        if input_domain == "spectral":
            field = torch.fft.irfft2(field, s=tuple(bp_filter["shape"]))
        if subtract_mean:
            field_mean = field.mean()
            field = field - field_mean
            result["field_mean"] = field_mean
        if mask is not None:
            mask = torch.as_tensor(mask, device=field.device)
        levels, means, stds = decompose_core(field, weights_2d, mask=mask, normalize=normalize)

    if compact_output:
        weight_masks = weights_2d > 1e-12
        result["weight_masks"] = weight_masks
        result["cascade_levels"] = [levels[i][weight_masks[i]] for i in range(levels.shape[0])]
    else:
        result["cascade_levels"] = levels
    if compute_stats:
        result["means"] = means
        result["stds"] = stds
    return result


def recompose_fft(decomp, **kwargs):
    """Dict-API recomposition: the sum of the levels (de-normalized where
    they were normalized), spatial or as an rfft2 half-plane by the
    decomposition's domain, with the subtracted mean added back.  A
    spectral result of odd width needs ``shape=(m, n)``."""
    levels = decomp["cascade_levels"]
    if decomp.get("compact_output"):
        weight_masks = torch.as_tensor(decomp["weight_masks"])
        dense = torch.zeros(weight_masks.shape, dtype=torch.complex64,
                            device=weight_masks.device)
        for i in range(weight_masks.shape[0]):
            dense[i][weight_masks[i]] = levels[i]
        levels = dense
    if decomp["domain"] == "spectral":
        shape = kwargs.get("shape")
        if shape is None:
            shape = (levels.shape[-2], 2 * (levels.shape[-1] - 1))
        if decomp["normalized"]:
            result = torch.sum(levels * decomp["stds"][:, None, None], dim=0)
            result[0, 0] += torch.sum(decomp["means"]) * (shape[0] * shape[1])
        else:
            result = torch.sum(levels, dim=0)
    elif decomp["normalized"]:
        result = recompose_core(levels, decomp["means"], decomp["stds"])
    else:
        result = torch.sum(levels, dim=0)
    if "field_mean" in decomp:
        if decomp["domain"] == "spectral":
            m, n = decomp.get("shape", (levels.shape[-2], 2 * (levels.shape[-1] - 1)))
            result[0, 0] += decomp["field_mean"] * m * n
        else:
            result = result + decomp["field_mean"]
    return result
