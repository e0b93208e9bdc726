"""
Piecewise-linear empirical-CDF matching: the LUT build in plain PyTorch
and the three PWL apply kernels (counterpart of
``pysteps_tpu/ops/pallas_histmatch.py``).

The match is a monotone 128-knot piecewise-linear quantile map.  Per
member and lead time, :func:`build_pwl_coeffs` places the knots, measures
the forecast ranks at them, reads the target quantiles off the binned
target CDF of :func:`prepare_target` and applies the wet-area-ratio
adjustment; :func:`match_cdf_pwl` then maps every pixel, dispatching as
the JAX package does: :func:`pack_gather_lut` (8 blocks of 16 knots) and
:func:`pwl_apply_gather` (K3, ``csrc/pwl.cu``) when the field tiles into
the TPU kernel's 32-row chunks, else ``pallas_chain.pack_hier_lut`` (16
blocks of 8) and :func:`pwl_apply_hier` (``csrc/pwl_variants.cu``).
:func:`match_cdf_pwl_flat` applies the flat 128-edge form through
:func:`pwl_apply` (``csrc/pwl_variants.cu``).  :func:`cdf_counts`
(``csrc/cdf.cu``) counts the pixels at or above 128 edges exactly; the
LUT build keeps its own plain counts of the 16 tail edges, as the JAX
package's does.  Everything is batched over a leading member axis.
"""

import torch

from pysteps_tpu_torch.ops import _kernels

K = 128  # PWL edges / CDF measurement points
B_T = 16384  # target CDF bins
_TILE = 2048  # rows of 128 pixels per grid step in the TPU kernels' tiling
_RC = 64  # rows of 128 pixels per chunk in the TPU kernel's tiling


def _tile_rows(rows):
    """The TPU kernels' rows per grid step for a field of ``rows`` rows of
    128 pixels; :func:`match_cdf_pwl` dispatches on it."""
    if rows % _TILE == 0:
        return _TILE
    for tr in (_RC, 16, 8):
        if rows % tr == 0:
            return tr
    return rows


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
    # a true division, as the JAX package's: ``float / tensor`` would
    # multiply by a rounded reciprocal and shift bin edges by an ulp
    tscale = torch.full_like(thi, B_T - 1.0) / torch.clamp(thi - tlo, min=1e-12)
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


def _scalars(B, q0, zval, ztrg):
    """The (B, 3) [q0, zval, ztrg] block the PWL kernels read per member."""
    return torch.stack(
        [torch.as_tensor(v, device=q0.device).expand(B) for v in (q0, zval, ztrg)],
        dim=1,
    ).to(torch.float32).contiguous()


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


def _pwl_prefix_ok(T):
    """(B,) bool: the members whose gather LUT ``T`` (B, 8, 48) K3 and
    chain stage 1 evaluate from prefix tables: every row's 15 fine edges
    nondecreasing and free of NaN, every d0/d1 term finite.  Then the
    terms a pixel selects are a prefix and the terms after it add +-0."""
    edges = T[:, :, :15]
    ordered = (edges[:, :, 1:] >= edges[:, :, :-1]).all(dim=2).all(dim=1)
    return ordered & torch.isfinite(T[:, :, 15:45]).all(dim=2).all(dim=1)


def _pwl_prefix_tables(T):
    """The running sums (B, 8, 16) of each row's d0 and d1 terms after t =
    0..15 of them, from the row's prefix, added left to right as K3 adds
    them."""
    acc0, acc1 = [T[:, :, 45]], [T[:, :, 46]]
    for j in range(15):
        acc0.append(acc0[-1] + T[:, :, 15 + j] * 1.0)
        acc1.append(acc1[-1] + T[:, :, 30 + j] * 1.0)
    return torch.stack(acc0, dim=2), torch.stack(acc1, dim=2)


def _pwl_prefix_acc(x, e8, T):
    """The two sums of the prefix-table PWL evaluation that K3 and chain
    stage 1 share (``common.cuh``) on (B, N): the block
    index, a 4-step search for t = #{j : x >= fine edge j} among the
    block's sorted fine edges, and the two running sums after t terms."""
    B = x.shape[0]
    idx = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    for g in range(1, 8):
        idx += (x >= e8[:, g : g + 1]).long()
    edges = T[:, :, :15].reshape(B, -1)
    t = torch.zeros_like(idx)
    for step in (8, 4, 2, 1):
        e = torch.gather(edges, 1, idx * 15 + t + step - 1)
        t += step * (x >= e).long()
    P0, P1 = _pwl_prefix_tables(T)
    return (torch.gather(P0.reshape(B, -1), 1, idx * 16 + t),
            torch.gather(P1.reshape(B, -1), 1, idx * 16 + t))


def _pwl_apply_prefix_plain(x, e8, T, q0, zval, ztrg):
    """Plain model of the PWL evaluation of K3 and chain stage 1 on (B, N)
    (the sums
    of :func:`_pwl_prefix_acc`, then K3's last two operations).  Equal
    under == to :func:`_pwl_apply_gather_plain` for the members that pass
    :func:`_pwl_prefix_ok`; the others take that 15-term sum, as the kernel
    does."""
    acc0, acc1 = _pwl_prefix_acc(x, e8, T)
    out = q0[:, None] + acc0 + x * acc1
    out = torch.where(x == zval[:, None], ztrg[:, None].expand_as(out), out)
    ok = _pwl_prefix_ok(T)
    if bool(ok.all()):
        return out
    slow = _pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg)
    return torch.where(ok[:, None], out, slow)


def pwl_apply_gather(x, e8, T, q0, zval, ztrg):
    """K3 (replaces ``pwl_apply_gather``): the block-gathered PWL map of
    ``x`` (B, N) with the dry override (``x == zval`` -> ``ztrg``); ``e8``
    (B, 8), ``T`` (B, 8, 48) from :func:`pack_gather_lut`, ``q0``/``zval``/
    ``ztrg`` (B,).  Works for any N.  The kernel evaluates the map from
    per-member prefix tables (:func:`_pwl_apply_prefix_plain` is its plain
    model), equal to the 15-term sum for every LUT."""
    if not x.is_cuda:
        return _pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg)
    B, N = x.shape
    if e8.shape != (B, 8) or T.shape != (B, 8, 48):
        raise ValueError("pwl_apply_gather: e8 must be (B, 8), T (B, 8, 48)")
    scal = _scalars(B, q0, zval, ztrg)
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


def _pwl_apply_hier_plain(x, e16, M3, q0, zval, ztrg):
    """Plain version of the hierarchical kernel on (B, N), in its
    summation order."""
    B = x.shape[0]
    g = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    for k in range(16):
        g += (x >= e16[:, k : k + 1]).long()
    sel = _hier_table(M3)  # (B, 24, 16)
    table = torch.cat([torch.zeros_like(sel[:, :, :1]), sel], dim=2)

    def col(c):
        return torch.gather(table[:, c], 1, g)

    s0 = torch.zeros_like(x)
    s1 = torch.zeros_like(x)
    for f in range(7):
        sf = (x >= col(f)).to(torch.float32)
        s0 = s0 + col(7 + f) * sf
        s1 = s1 + col(14 + f) * sf
    out = q0.reshape(B, 1) + ((col(21) + s0) + x * (col(22) + s1))
    return torch.where(x == zval.reshape(B, 1), ztrg.reshape(B, 1).expand_as(out), out)


def _tree_src(levels):
    """The index into ``e`` of each node 1 .. 2^L - 1 of the implicit
    search tree over the sorted values ``e[1 .. 2^L - 1]`` that the
    hierarchical and flat kernels keep (``common.cuh::pst_tree_src``; slot 0
    is unused and points at ``e[0]``): node i at depth d, position p within
    its level, holds ``e[(2p + 1) << (L - 1 - d)]``."""
    src = [0]
    for i in range(1, 1 << levels):
        d = i.bit_length() - 1
        src.append((2 * (i - (1 << d)) + 1) << (levels - 1 - d))
    return src


def _tree_count(x, e, levels):
    """#{j : x >= e[:, j]} for ``x`` (B, N) and ``e`` (B, 2^L), each row
    nondecreasing with any NaN last (so that x >= e[:, j] holds for a
    prefix of j), the kernels' way: L steps down the tree over ``e[:, 1:]``,
    then one compare with ``e[:, 0]``."""
    tree = e[:, _tree_src(levels)]
    i = torch.ones(x.shape, dtype=torch.long, device=x.device)
    for _ in range(levels):
        i = 2 * i + (x >= torch.gather(tree, 1, i)).long()
    return i - (1 << levels) + (x >= e[:, :1]).long()


def _hier_table(M3):
    """The (B, 24, 16) f32 table ``(a + b) + c`` of ``M3``'s three splits."""
    return (M3[:, 0:24] + M3[:, 24:48]) + M3[:, 48:72]


def _pwl_hier_prefix_ok(e16, M3):
    """(B,) bool: the members whose hierarchical LUT the kernel evaluates
    from prefix tables: each block's 7 fine edges nondecreasing and free of
    NaN, every d0/d1 term finite, and the 16 block starts nondecreasing and
    free of NaN (the kernel finds the block by a search)."""
    sel = _hier_table(M3)
    fine = sel[:, 0:7]
    ordered = (fine[:, 1:] >= fine[:, :-1]).all(dim=1).all(dim=1)
    finite = torch.isfinite(sel[:, 7:21]).all(dim=1).all(dim=1)
    return ordered & finite & (e16[:, 1:] >= e16[:, :-1]).all(dim=1)


def _pwl_hier_prefix_tables(M3):
    """The (B, 17, 8) tables (pb0 + S0[t], pb1 + S1[t]): S the running sums
    from +0 of a block's first t d0 (d1) terms, added left to right as the
    7-term sum adds them; row 0 (no block) zeros, row g + 1 block g."""
    sel = _hier_table(M3)
    sel = torch.cat([torch.zeros_like(sel[:, :, :1]), sel], dim=2)  # (B, 24, 17)
    out = []
    for c in (0, 1):
        acc = torch.zeros_like(sel[:, 0])
        steps = [sel[:, 21 + c] + acc]
        for f in range(7):
            acc = acc + sel[:, 7 + 7 * c + f] * 1.0
            steps.append(sel[:, 21 + c] + acc)
        out.append(torch.stack(steps, dim=2))
    return out[0], out[1]


def _pwl_hier_prefix_acc(x, e16, M3):
    """The hierarchical kernel's table entries on (B, N): the block g from
    the tree over the block starts, a 3-step search for t among block g's
    sorted fine edges, and row g's (pb0 + S0[t], pb1 + S1[t])."""
    B = x.shape[0]
    g = _tree_count(x, e16, 4)
    sel = _hier_table(M3)
    fine = torch.cat([torch.zeros_like(sel[:, :7, :1]), sel[:, :7]], dim=2)
    fine = fine.transpose(1, 2).reshape(B, -1)  # (B, 17 * 7)
    t = torch.zeros_like(g)
    for step, off in ((4, 3), (2, 1), (1, 0)):
        e = torch.gather(fine, 1, g * 7 + t + off)
        t += step * (x >= e).long()
    A0, A1 = _pwl_hier_prefix_tables(M3)
    k = g * 8 + t
    return torch.gather(A0.reshape(B, -1), 1, k), torch.gather(A1.reshape(B, -1), 1, k)


def _pwl_apply_hier_prefix_plain(x, e16, M3, q0, zval, ztrg):
    """Plain model of the hierarchical kernel on (B, N): the entries of
    :func:`_pwl_hier_prefix_acc`, ``q0 + (A0 + x * A1)`` and the dry
    override.  Equal under == to :func:`_pwl_apply_hier_plain` for the
    members that pass :func:`_pwl_hier_prefix_ok`; the others take that
    7-term sum, as the kernel does."""
    B = x.shape[0]
    a0, a1 = _pwl_hier_prefix_acc(x, e16, M3)
    out = q0.reshape(B, 1) + (a0 + x * a1)
    out = torch.where(x == zval.reshape(B, 1), ztrg.reshape(B, 1).expand_as(out), out)
    ok = _pwl_hier_prefix_ok(e16, M3)
    if bool(ok.all()):
        return out
    slow = _pwl_apply_hier_plain(x, e16, M3, q0, zval, ztrg)
    return torch.where(ok[:, None], out, slow)


def pwl_apply_hier(x, e16, M3, q0, zval, ztrg):
    """Hierarchical PWL map (replaces ``pwl_apply_hier``) of ``x`` (B, N)
    with the dry override; ``e16`` (B, 16), ``M3`` (B, 72, 16) from
    ``pallas_chain.pack_hier_lut``, ``q0``/``zval``/``ztrg`` (B,).  A pixel
    below ``e16[:, 0]`` maps to ``q0``.  Works for any N.  The kernel
    evaluates the map from per-member prefix tables
    (:func:`_pwl_apply_hier_prefix_plain` is its plain model), equal to the
    7-term sum for every LUT."""
    if not x.is_cuda:
        return _pwl_apply_hier_plain(x, e16, M3, q0, zval, ztrg)
    B, N = x.shape
    if e16.shape != (B, 16) or M3.shape != (B, 72, 16):
        raise ValueError("pwl_apply_hier: e16 must be (B, 16), M3 (B, 72, 16)")
    scal = _scalars(B, q0, zval, ztrg)
    _kernels.check_inputs(
        "pwl_apply_hier", (x, e16, M3, scal), (torch.float32,) * 4
    )
    out = torch.empty_like(x)
    _kernels.launch(
        "pst_pwl_hier", x.device, x.data_ptr(), e16.data_ptr(),
        M3.data_ptr(), scal.data_ptr(), out.data_ptr(), B, N,
    )
    _kernels.LAUNCHES["pwl_hier"] += 1
    return out


def _pwl_apply_plain(x, edges, w, q0):
    """Plain version of the flat kernel on (B, N): the 128 terms summed in
    edge order (IEEE products: an infinite or NaN weight gives NaN where
    its edge is not selected)."""
    W0, W1 = _flat_terms(w)
    acc0 = torch.zeros_like(x)
    acc1 = torch.zeros_like(x)
    for j in range(K):
        sf = (x >= edges[:, j : j + 1]).to(torch.float32)
        acc0 = acc0 + W0[:, j : j + 1] * sf
        acc1 = acc1 + W1[:, j : j + 1] * sf
    return (q0.reshape(-1, 1) + acc0) + x * acc1


def _flat_terms(w):
    """The (B, 128) weights W0 = (w0 + w1) + w2 and W1 = (w3 + w4) + w5."""
    return (w[:, 0] + w[:, 1]) + w[:, 2], (w[:, 3] + w[:, 4]) + w[:, 5]


def _pwl_flat_prefix_ok(edges, w):
    """(B,) bool: the members whose flat LUT the kernel evaluates from a
    prefix table: the 128 edges nondecreasing and free of NaN, every W0/W1
    finite."""
    W0, W1 = _flat_terms(w)
    ordered = (edges[:, 1:] >= edges[:, :-1]).all(dim=1)
    return ordered & torch.isfinite(W0).all(dim=1) & torch.isfinite(W1).all(dim=1)


def _pwl_flat_prefix_tables(w, q0):
    """The (B, 129) tables q0 + P0[t] and P1[t]: P the running sums from +0
    of the first t W0 (W1) terms, added in edge order as the 128-term sum
    adds them."""
    W0, W1 = _flat_terms(w)
    p0 = torch.zeros_like(W0[:, 0])
    p1 = torch.zeros_like(p0)
    A0, P1 = [q0 + p0], [p1]
    for j in range(K):
        p0 = p0 + W0[:, j] * 1.0
        p1 = p1 + W1[:, j] * 1.0
        A0.append(q0 + p0)
        P1.append(p1)
    return torch.stack(A0, dim=1), torch.stack(P1, dim=1)


def _pwl_apply_flat_prefix_plain(x, edges, w, q0):
    """Plain model of the flat kernel on (B, N): t = #{j : x >= edges[j]}
    from the tree over the sorted edges, then ``A0[t] + x * P1[t]``.  Equal
    under == to :func:`_pwl_apply_plain` for the members that pass
    :func:`_pwl_flat_prefix_ok`; the others take that 128-term sum, as the
    kernel does."""
    q0 = q0.expand(x.shape[0])
    t = _tree_count(x, edges, 7)
    A0, P1 = _pwl_flat_prefix_tables(w, q0)
    out = torch.gather(A0, 1, t) + x * torch.gather(P1, 1, t)
    ok = _pwl_flat_prefix_ok(edges, w)
    if bool(ok.all()):
        return out
    return torch.where(ok[:, None], out, _pwl_apply_plain(x, edges, w, q0))


def pwl_apply(x, edges, w, q0):
    """Flat 128-edge PWL map (replaces ``pwl_apply``) of ``x`` (B, N):
    ``q0 + cum @ (w0 + w1 + w2) + x * (cum @ (w3 + w4 + w5))`` with
    ``cum_j = 1[x >= edges_j]``; ``edges`` (B, 128), ``w`` (B, 8, 128) of
    bf16x3 delta rows (rows 6-7 unused), ``q0`` (B,).  No dry override.
    Works for any N.  The kernel evaluates the map from a per-member prefix
    table (:func:`_pwl_apply_flat_prefix_plain` is its plain model), equal
    to the 128-term IEEE sum for every LUT."""
    if not x.is_cuda:
        return _pwl_apply_plain(x, edges, w, q0)
    B, N = x.shape
    if edges.shape != (B, K) or w.shape != (B, 8, K):
        raise ValueError("pwl_apply: edges must be (B, 128), w (B, 8, 128)")
    q0 = q0.expand(B).to(torch.float32).contiguous()
    _kernels.check_inputs(
        "pwl_apply", (x, edges, w, q0), (torch.float32,) * 4
    )
    out = torch.empty_like(x)
    _kernels.launch(
        "pst_pwl_flat", x.device, x.data_ptr(), edges.data_ptr(),
        w.data_ptr(), q0.data_ptr(), out.data_ptr(), B, N,
    )
    _kernels.LAUNCHES["pwl_flat"] += 1
    return out


def match_cdf_pwl(initial, tstate):
    """PWL CDF match of ``initial`` (B, ...) against the prepared target:
    rank-conserving value transfer, wet-area-ratio adjustment, dry-pixel
    override.  Dispatches as the JAX package does
    (``pysteps_tpu/ops/pallas_histmatch.py:473-478``): K3 when the field's
    rows of 128 pixels tile into the TPU kernel's 32-row chunks, the
    hierarchical map otherwise (where the two differ: a pixel below the
    first knot maps to ``q0`` in the hierarchical map)."""
    from pysteps_tpu_torch.ops.pallas_chain import pack_hier_lut

    B = initial.shape[0]
    init = initial.reshape(B, -1).contiguous()
    edges, d0, d1, q0, zvalue, zvalue_trg = build_pwl_coeffs(init, tstate)
    ztrg = torch.as_tensor(zvalue_trg, dtype=torch.float32, device=init.device)
    if _tile_rows(init.shape[1] // 128) % 32 == 0:
        e8, T = pack_gather_lut(edges, d0, d1)
        out = pwl_apply_gather(init, e8, T, q0, zvalue, ztrg.expand(B))
    else:
        e16, M3 = pack_hier_lut(edges, d0, d1)
        out = pwl_apply_hier(init, e16, M3, q0, zvalue, ztrg.expand(B))
    return out.reshape(initial.shape)


def flat_weights(d0, d1):
    """The (B, 8, 128) weight block of :func:`pwl_apply`: the delta rows
    ``d0`` and ``d1`` each split into three bf16-exact parts by masking
    bits (not by a round trip through bf16), rows 6-7 zero."""
    from pysteps_tpu_torch.ops.pallas_chain import _bf16_mask

    def split3(vals):
        a = _bf16_mask(vals)
        r1 = vals - a
        b = _bf16_mask(r1)
        return a, b, r1 - b

    rows = torch.stack(split3(d0) + split3(d1), dim=1)
    return torch.cat([rows, d0.new_zeros((d0.shape[0], 2, K))], dim=1).contiguous()


def match_cdf_pwl_flat(initial, tstate):
    """Flat 128-edge variant of :func:`match_cdf_pwl` (the JAX package's
    comparison path): the map through :func:`pwl_apply` with the weights
    of :func:`flat_weights`, then the dry override."""
    B = initial.shape[0]
    init = initial.reshape(B, -1).contiguous()
    edges, d0, d1, q0, zvalue, zvalue_trg = build_pwl_coeffs(init, tstate)
    out = pwl_apply(init, edges.contiguous(), flat_weights(d0, d1), q0)
    out = torch.where(init == zvalue[:, None], zvalue_trg, out)
    return out.reshape(initial.shape)


_PLAIN_CHUNK = 1 << 24  # elements of the plain version's compare per step


def _cdf_counts_plain(x, edges):
    """Plain version of :func:`cdf_counts` on ``x`` (B, N) and ``edges``
    (B, 128): integer compare-and-count over chunks of pixels, converted to
    f32 once."""
    B, N = x.shape
    counts = torch.zeros((B, K), dtype=torch.int64, device=x.device)
    step = max(1, _PLAIN_CHUNK // max(B * K, 1))
    for p in range(0, N, step):
        counts += (x[:, None, p : p + step] >= edges[:, :, None]).sum(dim=2)
    return counts.to(torch.float32)


def _cdf_sort(edges):
    """The kernel's rank sort of ``edges`` (B, 128): by a key, the value's
    bits ordered as unsigned integers (the largest key where isnan: a NaN
    with its sign bit set would otherwise sort below -inf), then by index.
    The sorted edges are nondecreasing with any NaN last (-0 before +0,
    which compare equal).  Returns them and the permutation ``perm`` with
    ``sorted[:, s] = edges[:, perm[:, s]]``."""
    bits = edges.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 2**31, 0xFFFFFFFF - bits, bits + 2**31)
    key = torch.where(torch.isnan(edges), 0xFFFFFFFF, key)
    perm = torch.argsort(key * K + torch.arange(K, device=edges.device), dim=1)
    return torch.gather(edges, 1, perm), perm


def _cdf_counts_search_plain(x, edges):
    """Plain model of the ``cdf_counts`` kernel on ``x`` (B, N) and
    ``edges`` (B, 128): the edges sorted by :func:`_cdf_sort`, each pixel's
    ``k = #{s : x >= sorted[s]}`` from the tree search
    (:func:`_tree_count`: x >= sorted[s] holds for a prefix of s, the NaNs
    sitting last), a 129-bin histogram of k, its suffix sums
    ``cnt[s] = sum_{k > s} hist[k]`` and their scatter to ``perm[s]``.
    Equal to :func:`_cdf_counts_plain` for every input; used on no path."""
    srt, perm = _cdf_sort(edges)
    k = _tree_count(x, srt, 7)
    hist = torch.zeros((x.shape[0], K + 1), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, k, torch.ones_like(k))
    cnt = hist.flip(1).cumsum(1).flip(1)[:, 1:]
    return torch.zeros_like(cnt).scatter_(1, perm, cnt).to(torch.float32)


def cdf_counts(field, edges):
    """Exact counts ``#(x >= edges[j])`` at 128 edges (replaces
    ``cdf_counts``).

    ``edges`` (128,): counted over every pixel of ``field`` (any shape),
    returns (128,), the JAX function's form.  ``edges`` (B, 128) with
    ``field`` (B, ...): counted per member, returns (B, 128), as
    ``vmap(cdf_counts)``.  Edges need not be sorted, a NaN edge counts 0,
    a NaN pixel counts under no edge.  The kernel sorts each member's edges
    and counts each pixel once, by a search and a 129-bin histogram
    (:func:`_cdf_counts_search_plain` is its plain model), in one launch
    that writes the f32 counts.  The counts are integers converted to f32
    once, so they are exact below 2^24 pixels a member (where the JAX
    function's f32 sums are exact too) and the nearest f32 above.  Any
    pixel count works on the card (the TPU kernel needs a multiple of 128);
    at most 2^31 - 1 a member."""
    if edges.shape[-1] != K or edges.dim() not in (1, 2):
        raise ValueError(f"cdf_counts: edges must be ({K},) or (B, {K}), got {tuple(edges.shape)}")
    batched = edges.dim() == 2
    B = edges.shape[0] if batched else 1
    if batched and (field.dim() < 1 or field.shape[0] != B):
        raise ValueError("cdf_counts: field must be (B, ...) for edges (B, 128)")
    if not field.is_cuda:
        out = _cdf_counts_plain(field.reshape(B, -1), edges.reshape(B, K))
        return out if batched else out[0]
    _kernels.check_inputs("cdf_counts", (field, edges), (torch.float32,) * 2)
    x = field.view(B, -1)
    N = x.shape[1]
    if N >= 2**31:
        raise ValueError("cdf_counts: at most 2^31 - 1 pixels a member")
    work = torch.empty((B, K + 1), dtype=torch.int32, device=x.device)
    out = torch.empty((B, K), dtype=torch.float32, device=x.device)
    _kernels.launch(
        "pst_cdf_counts", x.device, x.data_ptr(), edges.data_ptr(),
        work.data_ptr(), out.data_ptr(), B, N,
    )
    _kernels.LAUNCHES["cdf_counts"] += 1
    return out if batched else out[0]
