"""Probability matching (counterpart of
``pysteps_tpu/postprocessing/probmatching.py``): the CDF matchers of the
STEPS scan (``_match_cdf_presorted``, ``prepare_cdf_matcher``; fields
carry a leading member axis ``(B, ...)`` and share one sorted target),
the public exact matcher, the PMM interpolator, two-moment matching and
the resampling of two distributions.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.ops import pallas_histmatch
from pysteps_tpu_torch.utils.arrays import _nanmin
from pysteps_tpu_torch.utils.transformation import _interp as interp

# packed-sort quantization: fewest value bits for the packed keys
_VALUE_BITS_MIN = 12


def _match_cdf_presorted(initial, ranked, zvalue_trg, exact=False):
    """Match each member of ``initial`` (B, ...) to the sorted target
    ``ranked`` (N,) with minimum ``zvalue_trg``, or each to its own target,
    ``ranked`` (B, N) and ``zvalue_trg`` (B,): rank-conserving value
    transfer, wet-area-ratio adjustment, dry-pixel override.

    ``exact``: two stable sorts, output values a permutation of the
    (adjusted) target.  Otherwise, when the value bits allow, each sort is
    a single-key sort of (quantized value | pixel id) packed into one word
    (the JAX package's uint32 layout, held here in int64); outputs are the
    dequantized target."""
    B = initial.shape[0]
    init = initial.reshape(B, -1)
    size = init.shape[1]

    zvalue = _nanmin(init, dim=1)
    idxzeros = init == zvalue[:, None]

    # wet-area-ratio adjustment of the target, per member
    ranked = ranked.reshape(-1, size)  # (1 or B, N)
    zvalue_trg = torch.as_tensor(zvalue_trg, device=ranked.device).reshape(-1, 1)
    n_wet_init = (init > zvalue[:, None]).sum(dim=1)
    n_wet_trg = (ranked > zvalue_trg).sum(dim=1)
    war = n_wet_init.to(torch.float32) / float(size)
    p_idx = torch.clamp(
        torch.round((1.0 - war) * (size - 1)).to(torch.int32), 0, size - 1
    )
    p = torch.gather(ranked.expand(B, size), 1, p_idx.long()[:, None])
    adjust = (n_wet_trg > n_wet_init)[:, None] & (ranked < p)
    ranked_b = torch.where(adjust, zvalue_trg, ranked)

    index_bits = max(int(size - 1).bit_length(), 1)
    value_bits = 32 - index_bits
    if exact or value_bits < _VALUE_BITS_MIN:
        orderin = torch.sort(init, dim=1, stable=True).indices
        out = torch.empty_like(init).scatter_(1, orderin, ranked_b)
    else:
        levels = 2**value_bits - 1
        levels_f = torch.tensor(levels, dtype=torch.float32, device=init.device)
        iota = torch.arange(size, dtype=torch.int64, device=init.device)
        lo = init.amin(dim=1, keepdim=True)
        hi = init.amax(dim=1, keepdim=True)
        scale = levels_f / torch.clamp(hi - lo, min=1e-12)
        q = torch.round((init - lo) * scale).to(torch.int64)
        orderin = torch.sort((q << index_bits) | iota, dim=1).values & (
            2**index_bits - 1
        )
        tlo = ranked_b[:, :1]
        thi = ranked_b[:, -1:]
        tscale = levels_f / torch.clamp(thi - tlo, min=1e-12)
        tq = torch.round((ranked_b - tlo) * tscale).to(torch.int64)
        s2 = torch.sort((orderin << value_bits) | tq, dim=1).values
        out = (s2 & levels).to(torch.float32) / tscale + tlo
    out = torch.where(idxzeros, zvalue_trg, out)
    return out.reshape(initial.shape)


def _prepare_cdf_target(target):
    """Sort and NaN-fill the matching target once; returns (ranked,
    zvalue_trg)."""
    targ = target.reshape(-1)
    zvalue_trg = _nanmin(targ)
    targ = torch.where(torch.isnan(targ), zvalue_trg, targ)
    return torch.sort(targ).values, zvalue_trg


def prepare_cdf_matcher(target, pwl):
    """The per-forecast matcher ``(match_fn, state)`` with
    ``match_fn(fields (B, m, n), state)``.  ``pwl=True`` selects the
    piecewise-linear quantile map (kernel K3, ``ops/pallas_histmatch.py``;
    the JAX package's path on the TPU), ``False`` the packed sort matcher
    (its path on the CPU).  The callers choose by device: PWL on CUDA when
    :func:`pallas_histmatch.supported` holds."""
    ranked, zvalue = _prepare_cdf_target(target)
    if pwl:
        state = pallas_histmatch.prepare_target(ranked, zvalue)
        return pallas_histmatch.match_cdf_pwl, state
    return (lambda f, s: _match_cdf_presorted(f, s[0], s[1])), (ranked, zvalue)


def _match_cdf_core(initial, target):
    """The public matcher keeps the reference's exact semantics: output
    values are a permutation of the target's."""
    ranked, zvalue_trg = _prepare_cdf_target(target)
    return _match_cdf_presorted(initial[None], ranked, zvalue_trg, exact=True)[0]


def nonparam_match_empirical_cdf(initial_array, target_array, ignore_indices=None,
                                 device=None):
    """Match the empirical CDF of ``initial_array`` to ``target_array``,
    conserving ranks and zero pixels.  ``ignore_indices``, a bool mask of
    the field's shape or flat indices, keeps those pixels as they are and
    out of the ranking."""
    initial = as_device_tensor(initial_array, device, torch.float32)
    target = as_device_tensor(target_array, initial.device, torch.float32)
    if initial.numel() != target.numel():
        raise ValueError("dimension mismatch between initial_array and target_array")
    if ignore_indices is None:
        return _match_cdf_core(initial, target)
    ignore = torch.as_tensor(ignore_indices, device=initial.device)
    if ignore.dtype != torch.bool:
        mask = torch.zeros(initial.numel(), dtype=torch.bool, device=initial.device)
        mask[ignore.reshape(-1).long()] = True
        mask = mask.reshape(initial.shape)
    else:
        mask = ignore
    filled = torch.where(mask, _nanmin(initial), initial)
    return torch.where(mask, initial, _match_cdf_core(filled, target))


def compute_empirical_cdf(bin_edges, hist, device=None):
    """Empirical CDF from a histogram over ``bin_edges``, 0 at the first
    edge and 1 at the last."""
    bin_edges = as_device_tensor(bin_edges, device, torch.float32)
    hist = as_device_tensor(hist, bin_edges.device, torch.float32)
    widths = bin_edges[1:] - bin_edges[:-1]
    cdf = torch.cat([torch.zeros(1, device=bin_edges.device), torch.cumsum(widths * hist, 0)])
    return cdf / cdf[-1]


def pmm_init(bin_edges_1, cdf_1, bin_edges_2, cdf_2, device=None):
    """A probability-matching interpolator: the two CDFs and their bin
    edges as tensors on one device."""
    edges_1 = as_device_tensor(bin_edges_1, device, torch.float32)
    dev = edges_1.device
    return {
        "bin_edges_1": edges_1,
        "cdf_1": as_device_tensor(cdf_1, dev, torch.float32),
        "bin_edges_2": as_device_tensor(bin_edges_2, dev, torch.float32),
        "cdf_2": as_device_tensor(cdf_2, dev, torch.float32),
    }


def pmm_compute(pmm, x):
    """Map ``x`` through CDF 1, then through the inverse of CDF 2 (NaN
    where CDF 1 reaches 1)."""
    x = as_device_tensor(x, pmm["bin_edges_1"].device, torch.float32)
    p = interp(x, pmm["bin_edges_1"], pmm["cdf_1"])
    out = interp(p, pmm["cdf_2"], pmm["bin_edges_2"])
    return torch.where(p > 0.9999999, float("nan"), out)


def shift_scale(R, f, rain_fraction_trg, second_moment_trg, device=None, **kwargs):
    """Two-moment matching: the shift puts the target rain fraction above
    zero (the ``1 - rain_fraction_trg`` quantile), the scale matches the
    target second moment by 60 steps of bisection on [1e-3, 1e3].
    Returns (shift, scale, (R - shift) * scale)."""
    R = as_device_tensor(R, device, torch.float32)
    shift = torch.quantile(torch.sort(R.reshape(-1)).values, 1.0 - rain_fraction_trg)

    def second_moment(scale):
        x = (R - shift) * scale
        vals = torch.where(x > 0, 10.0 ** (x / 10.0) if f == "dB" else x, 0.0)
        return torch.mean(vals**2)

    one = torch.ones((), device=R.device)
    lo, hi = 1e-3 * one, 1e3 * one
    for _ in range(60):
        mid = torch.sqrt(lo * hi)
        if bool(second_moment(mid) < second_moment_trg):
            lo = mid
        else:
            hi = mid
    scale = torch.sqrt(lo * hi)
    return float(shift), float(scale), (R - shift) * scale


def _bernoulli(generator, p, shape):
    """The draw of :func:`resample_distributions`: True with probability
    ``p`` (a replaceable function, so that a test can hand in another
    library's draw)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u < p


def resample_distributions(first_array, second_array, probability_first_array,
                           randgen=None, key=None, device=None):
    """Mix the descending-sorted samples of two distributions: each rank
    takes the first array's value with probability
    ``probability_first_array``, else the second's.  NaNs are filled with
    the smallest value of both first.  ``key``: a ``torch.Generator`` (a
    generator seeded with 0 when None)."""
    if tuple(np.shape(first_array)) != tuple(np.shape(second_array)):
        raise ValueError("first_array and second_array must have the same shape")
    a = as_device_tensor(first_array, device, torch.float32).reshape(-1)
    b = as_device_tensor(second_array, a.device, torch.float32).reshape(-1)
    a = torch.where(torch.isnan(a), _nanmin(torch.stack([a, b])), a)
    b = torch.where(torch.isnan(b), _nanmin(torch.stack([a, b])), b)
    asort = torch.sort(a, descending=True).values
    bsort = torch.sort(b, descending=True).values
    if key is None:
        key = torch.Generator(device=a.device).manual_seed(0)
    pick = _bernoulli(key, probability_first_array, asort.shape)
    return torch.where(pick.to(a.device), asort, bsort)
