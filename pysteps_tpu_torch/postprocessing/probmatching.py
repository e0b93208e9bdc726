"""CDF probability matching of the STEPS scan (counterpart of
``_prepare_cdf_target``, ``_match_cdf_presorted`` and
``prepare_cdf_matcher`` in ``pysteps_tpu/postprocessing/probmatching.py``).

Fields carry a leading member axis ``(B, ...)``; the sorted target is
shared by all members.
"""

import torch

from pysteps_tpu_torch.ops import pallas_histmatch

# packed-sort quantization: fewest value bits for the packed keys
_VALUE_BITS_MIN = 12


def _nanmin(x, dim=None):
    filled = torch.where(torch.isnan(x), float("inf"), x)
    return filled.amin() if dim is None else filled.amin(dim=dim)


def _match_cdf_presorted(initial, ranked, zvalue_trg, exact=False):
    """Match each member of ``initial`` (B, ...) to the sorted target
    ``ranked`` (N,): rank-conserving value transfer, wet-area-ratio
    adjustment, dry-pixel override.

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
    n_wet_init = (init > zvalue[:, None]).sum(dim=1)
    n_wet_trg = (ranked > zvalue_trg).sum()
    war = n_wet_init.to(torch.float32) / float(size)
    p_idx = torch.clamp(
        torch.round((1.0 - war) * (size - 1)).to(torch.int32), 0, size - 1
    )
    p = ranked[p_idx.long()]
    adjust = (n_wet_trg > n_wet_init)[:, None] & (ranked[None, :] < p[:, None])
    ranked_b = torch.where(adjust, zvalue_trg, ranked[None, :])

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
