"""Noise standard-deviation adjustment (counterpart of
``pysteps_tpu/noise/utils.py``; Bowler, Pierce & Seed 2006): the ratio of
the observed field's cascade stds to those of masked noise, with the
``num_iter`` noise realizations drawn and decomposed as one member batch.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.cascade.decomposition import decompose_core
from pysteps_tpu_torch.noise.fftgenerators import (
    _generate_fft_noise,
    _generate_ssft_noise,
    _ssft_gen_masks,
)


def _stddev_adjs_core(
    precip, precip_thr, precip_min, weights_2d, noise_filt, input_shape,
    generator, num_iter, conditional, use_full_fft, ssft_masks=None,
):
    mask = precip >= precip_thr
    R = torch.where(torch.isfinite(precip), precip, precip_min)
    R = torch.where(mask, R, precip_min)
    stat_mask = mask if conditional else torch.ones_like(mask)
    w = stat_mask.to(R.dtype)
    cnt = torch.clamp(w.sum(), min=1.0)
    mu = (R * w).sum() / cnt
    sigma = torch.sqrt(((R - mu) ** 2 * w).sum() / cnt)
    dmask = stat_mask if conditional else None
    _, _, stds_obs = decompose_core(R - mu, weights_2d, mask=dmask, normalize=False)

    if ssft_masks is not None:
        N = _generate_ssft_noise(generator, noise_filt, ssft_masks, input_shape, num_iter)
    else:
        N = _generate_fft_noise(
            generator, noise_filt, input_shape, num_iter, use_full_fft=use_full_fft
        )
    N = N / N.std(dim=(-2, -1), keepdim=True, correction=0) * sigma + mu
    N = torch.where(mask, N, precip_min) - mu
    _, _, stds_noise = decompose_core(N, weights_2d, mask=dmask, normalize=False)
    return stds_obs / stds_noise.mean(dim=0)


def _float32(x, device):
    """A float32 tensor on ``device`` of a tensor or of a (possibly
    read-only, cached) numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def compute_noise_stddev_adjs(
    R, R_thr_1, R_thr_2, F, decomp_method, noise_filter, noise_generator, num_iter,
    conditional=True, num_workers=1, seed=None, generator=None,
):
    """Scale-dependent correction factors (k,) of masked noise cascades:
    the cascade stds of the field ``R`` (values below ``R_thr_1`` set to
    ``R_thr_2``) over the mean stds of ``num_iter`` noise fields from
    ``noise_filter``, scaled to the field's statistics and masked the same
    way.  ``F`` is the bandpass filter dict.  Runs on the filter's device;
    draws from ``generator`` (else one seeded with ``seed``).
    ``decomp_method``, ``noise_generator`` and ``num_workers`` are accepted
    for the JAX package's signature; the batched cores are used."""
    del decomp_method, noise_generator, num_workers
    filt = noise_filter["field"]
    dev = resolve_device(None, filt, R)
    filt = _float32(filt, dev)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed if seed is not None else 0)
    input_shape = tuple(noise_filter["input_shape"])
    ssft_masks = None
    if filt.ndim == 4:  # SSFT / nested (wy, wx, m, n) stack
        ssft_masks = _ssft_gen_masks(
            filt.shape, input_shape, noise_filter.get("overlap_gen", 0.2),
            noise_filter.get("win_fun", "tukey"), dev,
        )
    return _stddev_adjs_core(
        _float32(R, dev),
        float(np.float32(R_thr_1)),
        float(np.float32(R_thr_2)),
        _float32(F["weights_2d"], dev),
        filt, input_shape, generator, int(num_iter), bool(conditional),
        bool(noise_filter.get("use_full_fft", False)), ssft_masks=ssft_masks,
    )
