"""
Piecewise-linear empirical-CDF matching: the LUT build in plain PyTorch
and kernel K3, the PWL apply (counterpart of
``pysteps_tpu/ops/pallas_histmatch.py``).

The match is a monotone 128-knot piecewise-linear quantile map.  Per
member and lead time, :func:`build_pwl_coeffs` places the knots, measures
the forecast ranks at them, reads the target quantiles off the binned
target CDF of :func:`prepare_target` and applies the wet-area-ratio
adjustment; :func:`pack_gather_lut` repacks the coefficients into 8
blocks of 16 knots; :func:`pwl_apply_gather` (K3, ``csrc/pwl.cu``) maps
every pixel.  Everything is batched over a leading member axis.
"""

import torch

from pysteps_tpu_torch.ops import _kernels

K = 128  # PWL edges / CDF measurement points
B_T = 16384  # target CDF bins
_RC = 64  # rows of 128 pixels per chunk in the TPU kernel's tiling


def supported(shape):
    """The JAX package's gate for the PWL matcher (the field tiles into
    (8, 128) blocks and holds at least 64 rows of 128)."""
    size = 1
    for s in shape:
        size *= int(s)
    return size % (128 * 8) == 0 and size >= 128 * _RC


def prepare_target(ranked, zvalue_trg):
    """Bin the sorted match target once per forecast.  Returns
    (ranked, zvalue_trg, c_t inclusive cumulative bin counts (B_T,), tlo,
    tscale, n_wet_trg)."""
    tlo = ranked[0]
    thi = ranked[-1]
    tscale = (B_T - 1.0) / torch.clamp(thi - tlo, min=1e-12)
    tbins = torch.clamp(
        torch.round((ranked - tlo) * tscale).to(torch.int32), 0, B_T - 1
    )
    iota = torch.arange(B_T, dtype=torch.int32, device=ranked.device)
    # tbins is sorted: #(tbins <= v) is a right-sided search
    c_t = torch.searchsorted(tbins, iota, right=True).to(torch.int32)
    n_wet_trg = torch.sum(ranked > zvalue_trg)
    return ranked, zvalue_trg, c_t, tlo, tscale, n_wet_trg


def build_pwl_coeffs(init, tstate):
    """LUT build for the PWL match of ``init`` (B, N).  Returns
    (edges (B, K), d0 (B, K), d1 (B, K), q0 (B,), zvalue (B,), zvalue_trg)."""
    ranked, zvalue_trg, c_t, tlo, tscale, n_wet_trg = tstate
    B, size = init.shape
    dev = init.device

    lo = init.amin(dim=1)
    hi = init.amax(dim=1)
    span = torch.clamp(hi - lo, min=1e-12)

    # knots: uniform in value, equiprobable in forecast rank, log-spaced in
    # the upper tail, uniform in target value mapped back through the
    # forecast quantiles, and a bracket around the target's dry/wet rank
    n_uni, n_quant, n_tail, n_cliff = 24, 48, 8, 2
    n_out = K - n_uni - n_quant - n_tail - n_cliff
    ar = torch.arange(n_uni, dtype=torch.float32, device=dev) / (n_uni - 1.0)
    uniform = lo[:, None] + span[:, None] * ar
    n_sub = min(4096, size)
    stride = size // n_sub
    sub = torch.sort(init[:, : n_sub * stride : stride], dim=1).values
    quant = sub[:, :: n_sub // n_quant][:, :n_quant]
    tail = sub[:, [n_sub - (1 << i) for i in range(n_tail)]]
    rank_u = c_t[:: B_T // n_out][:n_out]
    pos = torch.clamp(rank_u // stride, 0, n_sub - 1).long()
    outk = sub[:, pos]
    n_dry_trg = size - n_wet_trg
    e_c = sub[:, torch.clamp(n_dry_trg // stride, 0, n_sub - 1)]
    cliff = torch.stack([e_c - span * 1e-8, e_c], dim=1)
    edges = torch.sort(
        torch.cat([uniform, quant, tail, outk, cliff], dim=1), dim=1
    ).values

    # forecast ranks r_j = #(x < e_j): from the sorted subsample, exact for
    # the top n_tail_exact edges
    n_tail_exact = 16
    r_sub = stride * torch.searchsorted(sub, edges).to(torch.float32)
    e_tail = edges[:, K - n_tail_exact :]
    ge = torch.stack(
        [(init >= e_tail[:, j : j + 1]).sum(dim=1) for j in range(n_tail_exact)],
        dim=1,
    )
    r_tail = size - ge.to(torch.float32)
    r = torch.cat([r_sub[:, : K - n_tail_exact], r_tail], dim=1).to(torch.int32)

    # target quantile at each edge rank: first bin v with c_t(v) > r_j
    v = torch.searchsorted(c_t, r, right=True)
    q = tlo + (v.to(torch.float32) + 0.5) / tscale
    q = torch.minimum(q, ranked[-1])

    # wet-area-ratio adjustment (reference: probmatching.py:106-112)
    zvalue = lo
    n_wet_init = torch.sum(init > zvalue[:, None], dim=1)
    war = n_wet_init.to(torch.float32) / float(size)
    p_idx = torch.clamp(
        torch.round((1.0 - war) * (size - 1)).to(torch.int32), 0, size - 1
    )
    p = ranked[p_idx.long()]
    adjust = (n_wet_trg > n_wet_init)[:, None] & (q < p[:, None])
    q = torch.where(adjust, zvalue_trg, q)
    q = torch.cummax(q, dim=1).values

    de = edges[:, 1:] - edges[:, :-1]
    tiny = (span * 1e-7)[:, None]
    slope = torch.where(
        de > tiny, (q[:, 1:] - q[:, :-1]) / torch.maximum(de, tiny), 0.0
    )
    slope = torch.cat([slope, torch.zeros_like(slope[:, :1])], dim=1)
    c0 = torch.cat([q[:, :-1] - slope[:, :-1] * edges[:, :-1], q[:, -1:]], dim=1)
    d0 = torch.diff(c0, dim=1, prepend=q[:, :1])
    d1 = torch.diff(slope, dim=1, prepend=torch.zeros_like(slope[:, :1]))
    return edges, d0, d1, q[:, 0], zvalue, zvalue_trg


def pack_gather_lut(edges, d0, d1):
    """Repack (B, K) coefficients into 8 blocks of 16 knots: the block
    starts ``e8`` (B, 8) and the (B, 8, 48) table
    [15 fine edges | 15 d0 | 15 d1 | prefix0 | prefix1 | pad]; each prefix
    sums all earlier blocks plus its own block's first delta."""
    B = edges.shape[0]
    eb = edges.reshape(B, 8, 16)
    b0 = d0.reshape(B, 8, 16)
    b1 = d1.reshape(B, 8, 16)
    zero = torch.zeros_like(b0[:, :1, 0])

    def prefix(bk):
        sums = torch.cumsum(bk.sum(dim=2), dim=1)
        return torch.cat([zero, sums], dim=1)[:, :8] + bk[:, :, 0]

    T = torch.cat(
        [
            eb[:, :, 1:], b0[:, :, 1:], b1[:, :, 1:],
            prefix(b0)[:, :, None], prefix(b1)[:, :, None],
            torch.zeros_like(b0[:, :, :1]),
        ],
        dim=2,
    )
    return eb[:, :, 0].contiguous(), T.contiguous()


def _pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg):
    """Plain version of K3 on (B, N) with the kernel's summation order."""
    idx = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    for g in range(1, 8):
        idx += (x >= e8[:, g : g + 1]).long()

    def col(c):
        return torch.gather(T[:, :, c], 1, idx)

    acc0 = col(45)
    acc1 = col(46)
    for j in range(15):
        sf = (x >= col(j)).to(torch.float32)
        acc0 = acc0 + col(15 + j) * sf
        acc1 = acc1 + col(30 + j) * sf
    out = q0[:, None] + acc0 + x * acc1
    return torch.where(x == zval[:, None], ztrg[:, None].expand_as(out), out)


def pwl_apply_gather(x, e8, T, q0, zval, ztrg):
    """K3 (replaces ``pwl_apply_gather``): the block-gathered PWL map of
    ``x`` (B, N) with the dry override (``x == zval`` -> ``ztrg``); ``e8``
    (B, 8), ``T`` (B, 8, 48) from :func:`pack_gather_lut`, ``q0``/``zval``/
    ``ztrg`` (B,).  Works for any N."""
    if not x.is_cuda:
        return _pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg)
    B, N = x.shape
    if e8.shape != (B, 8) or T.shape != (B, 8, 48):
        raise ValueError("pwl_apply_gather: e8 must be (B, 8), T (B, 8, 48)")
    scal = torch.stack(
        [q0.expand(B), zval.expand(B), ztrg.expand(B)], dim=1
    ).to(torch.float32).contiguous()
    _kernels.check_inputs(
        "pwl_apply_gather", (x, e8, T, scal), (torch.float32,) * 4
    )
    out = torch.empty_like(x)
    _kernels.launch(
        "pst_pwl_gather", x.device, x.data_ptr(), e8.data_ptr(),
        T.data_ptr(), scal.data_ptr(), out.data_ptr(), B, N,
    )
    _kernels.LAUNCHES["pwl_gather"] += 1
    return out


def match_cdf_pwl(initial, tstate):
    """PWL CDF match of ``initial`` (B, ...) against the prepared target:
    rank-conserving value transfer, wet-area-ratio adjustment, dry-pixel
    override.  Always applies through K3, whatever the field size."""
    B = initial.shape[0]
    init = initial.reshape(B, -1)
    edges, d0, d1, q0, zvalue, zvalue_trg = build_pwl_coeffs(init, tstate)
    e8, T = pack_gather_lut(edges, d0, d1)
    ztrg = torch.as_tensor(zvalue_trg, dtype=torch.float32, device=init.device)
    out = pwl_apply_gather(init.contiguous(), e8, T, q0, zvalue, ztrg.expand(B))
    return out.reshape(initial.shape)
