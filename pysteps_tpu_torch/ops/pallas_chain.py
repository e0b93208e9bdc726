"""
The fused STEPS spatial chain, PWL CDF match -> rim mask + warp, with its
plain PyTorch version (counterpart of ``pysteps_tpu/ops/pallas_chain.py``).

Per member and lead the unfused path runs three field-sized kernels on
the matched field: K3 (match), K4 (rim) and K2 (warp).  The chain
(``csrc/chain.cu``) walks full-height strips of each member, matches every
pixel of a strip (and of the rim's columns beside it) once into a ring of
shared-memory rows, and feeds both the rim and the vertical resample from
there (stage 1), then runs the horizontal resample with the out-of-domain
fill (stage 2): the matched field never reaches device memory.  Stage 1
evaluates the PWL map from per-member prefix tables
(``pallas_histmatch._pwl_apply_prefix_plain`` is its plain model), exact
for the sorted LUTs that ``pack_gather_lut`` gives and falling back to
K3's 15-term sum for any other.  The result equals the composition K3 ->
K2 (masked) and K3 -> K4, which is what the plain version computes.

Also here, as in the JAX package: the hierarchical LUT layout
(:func:`pack_hier_lut`, ``G`` blocks of ``L`` knots) that
``pallas_histmatch.pwl_apply_hier`` evaluates, and the bf16 split by bit
masking (:func:`_bf16_mask`).
"""

import ctypes

import torch

from pysteps_tpu_torch.ops import _kernels
from pysteps_tpu_torch.ops.pallas_dilate import _rim_plain
from pysteps_tpu_torch.ops.pallas_histmatch import _pwl_apply_gather_plain, _scalars
from pysteps_tpu_torch.ops.pallas_warp import _round8, _warp_h_plain, _warp_v_plain

K = 128
G = 16  # coarse blocks of the hierarchical layout
L = 8  # edges per block
# the JAX package's gate: a field of at most this many bytes (its
# whole-field TPU kernels keep ~9 field buffers in VMEM); the port keeps
# the gate so that both take the chain on the same configurations
CHAIN_MAX_FIELD_BYTES = 1_200_000
# the largest kr + r stage 1 takes with the rim: its distances are bytes
MAX_RIM = 254
# stage 1's strip constants in csrc/chain.cu (CV_W, CV_TH, CV_WARPS, CV_RPW,
# PST_PWL_LS of common.cuh), which :func:`_stage1_geometry` mirrors so that
# the geometry is known without the card; on the card :func:`stage1_info`
# checks it against the kernel's own
CV_W, CV_TH, CV_WARPS, CV_RPW, PWL_LS = 64, 32, 8, 4, 17


def supported(shape):
    """The chain's gate: m and n multiples of 128 and a small field."""
    m, n = shape
    return m % 128 == 0 and n % 128 == 0 and m * n * 4 <= CHAIN_MAX_FIELD_BYTES


def _bf16_mask(v):
    """The top 16 bits of each f32 (bf16 by truncation), by masking bits."""
    return (v.contiguous().view(torch.int32) & -65536).view(torch.float32)


def pack_hier_lut(edges, d0, d1):
    """Repack (B, K) PWL coefficients into the hierarchical layout: the
    block starts ``e16`` (B, G) and ``M3`` (B, 72, G), three bf16-exact
    splits a, b, c (M = (a + b) + c) of the (24, G) table
    [7 fine edges | 7 d0 | 7 d1 | prefix0 | prefix1 | pad] per block; each
    prefix sums all earlier blocks plus its own block's first delta."""
    B = edges.shape[0]
    e_blk = edges.reshape(B, G, L)
    b0 = d0.reshape(B, G, L)
    b1 = d1.reshape(B, G, L)
    zero = torch.zeros_like(b0[:, :1, 0])

    def prefix(bk):
        sums = torch.cumsum(bk.sum(dim=2), dim=1)
        return torch.cat([zero, sums], dim=1)[:, :G] + bk[:, :, 0]

    M = torch.cat(
        [
            e_blk[:, :, 1:].transpose(1, 2), b0[:, :, 1:].transpose(1, 2),
            b1[:, :, 1:].transpose(1, 2), prefix(b0)[:, None],
            prefix(b1)[:, None], torch.zeros_like(b0[:, None, :, 0]),
        ],
        dim=1,
    )  # (B, 24, G)
    a = _bf16_mask(M)
    r1 = M - a
    b = _bf16_mask(r1)
    return e_blk[:, :, 0].contiguous(), torch.cat([a, b, r1 - b], dim=1).contiguous()


def _chain_v_plain(field, e8, T, q0, zval, ztrg, thr, dy, D, kr, r, do_rim):
    """Plain version of stage 1 (D already rounded up to a multiple of 8):
    K3's map, then K2's vertical stage and K4's rim of the matched field."""
    B, m, n = field.shape
    matched = _pwl_apply_gather_plain(
        field.reshape(B, -1), e8, T, q0, zval, ztrg
    ).reshape(B, m, n)
    C = _warp_v_plain(matched, dy, D)
    rim = _rim_plain(matched, float(thr), kr, r) if do_rim else torch.zeros_like(matched)
    return C, rim


def _launch_v(entry, field, e8, T, scal, thr, dy, D, kr, r, do_rim, *extra):
    """Check stage 1's CUDA inputs and launch C entry ``entry`` on them
    (``extra`` after its own arguments); returns ``(C, rim)``."""
    B = field.shape[0]
    if e8.shape != (B, 8) or T.shape != (B, 8, 48):
        raise ValueError("match_warp_rim: e8 must be (B, 8), T (B, 8, 48)")
    if dy.shape != field.shape:
        raise ValueError("match_warp_rim: dy must be (B, m, n)")
    _kernels.check_inputs(
        "match_warp_rim", (field, e8, T, scal, dy), (torch.float32,) * 5
    )
    C = torch.empty_like(field)
    rim = torch.empty_like(field)
    _kernels.launch(
        entry, field.device, field.data_ptr(), e8.data_ptr(), T.data_ptr(),
        scal.data_ptr(), dy.data_ptr(), C.data_ptr(), rim.data_ptr(),
        *field.shape, D, int(kr), int(r), float(thr), int(bool(do_rim)), *extra,
    )
    return C, rim


def chain_match_vert_rim(field, e8, T, q0, zval, ztrg, thr, dy, D, kr, r,
                         do_rim=True, halo=None):
    """Stage 1 of the chain (replaces ``_k1_kernel``) on a (B, m, n)
    field: the PWL match, the vertical resample ``C`` of the matched field
    and its rim (zeros when ``do_rim`` is False).  Returns ``(C, rim)``.

    ``halo``, the matched rows kept above and below a tile in the first
    design, is only checked now: with the rim it must hold ``kr + r``
    rows, as before.  The kernel keeps every row a tap can reach (D above
    to D + 1 below) and does not read it, so it changes nothing.  On the
    card the ring of 2D + 65 rows (with ``kr + r <= D + 1``) must fit in
    shared memory, about D <= 320 for fields taller than the ring, and
    ``kr + r`` be at most :data:`MAX_RIM`; otherwise the launch is refused
    and this raises (the JAX kernel has neither limit)."""
    D = _round8(D)
    B = field.shape[0]
    if halo is not None and int(halo) < (kr + r if do_rim else 0):
        raise ValueError("match_warp_rim: the halo must hold the rim's kr + r rows")
    scal = _scalars(B, q0, zval, ztrg)
    if not field.is_cuda:
        return _chain_v_plain(field, e8, T, *scal.unbind(1), thr, dy, D, kr, r, do_rim)
    out = _launch_v("pst_chain_v", field, e8, T, scal, thr, dy, D, kr, r, do_rim)
    _kernels.LAUNCHES["chain_match_vert_rim"] += 1
    return out


def stage1_matches(field, e8, T, q0, zval, ztrg, thr, dy, D, kr, r, do_rim=True):
    """Stage 1 on CUDA inputs through the kernel's counting instantiation:
    ``(C, rim, matches)``, the outputs of :func:`chain_match_vert_rim` and
    the window pixels whose PWL map the blocks stored, over the batch, as
    counted on the card.  For measurement: not counted in
    ``_kernels.LAUNCHES``, and no path calls it."""
    scal = _scalars(field.shape[0], q0, zval, ztrg)
    count = torch.empty(1, dtype=torch.int64, device=field.device)
    C, rim = _launch_v("pst_chain_v_count", field, e8, T, scal, thr, dy,
                       _round8(D), kr, r, do_rim, count.data_ptr())
    return C, rim, int(count.item())


def _stage1_geometry(m, n, D, kr, r, do_rim):
    """Stage 1's strip geometry (``cv_geom`` in ``csrc/chain.cu``, whose
    layout this mirrors): ring rows, dynamic shared memory in bytes and the
    window pixels matched for one member (each strip's window, every
    row).  ``D`` as the kernel takes it (rounded)."""
    R = int(kr) + int(r)
    hc = R if do_rim else 0
    nw = (CV_W + 2 * hc + 31) // 32
    Dr = min(abs(int(D)), m)
    ring = min(m, 2 * CV_TH + max(Dr + 1, hc) + Dr)
    smem = 8 * PWL_LS * 8 + 8 * 48 * 4 + 8 * PWL_LS * 4 + 8 * 4 + ring * CV_W * 4
    if do_rim:
        smem += ((R + 2) * 4 + 15) // 16 * 16 + CV_WARPS * CV_RPW * nw * 4 + ring * CV_W
    matches = sum(m * (min(n, j0 + CV_W + hc) - max(0, j0 - hc))
                  for j0 in range(0, n, CV_W))
    return ring, smem, matches


def stage1_info(m, n, D, kr, r, do_rim=True, device=None):
    """What stage 1 asks of the card at these arguments (``D`` as the
    caller gives it), worked out from the kernel's geometry, not measured:
    ``smem_bytes`` of dynamic shared memory, ``ring_rows``,
    ``matches_per_output``, the PWL evaluations per output pixel when each
    window pixel is matched once (:func:`stage1_matches` counts them), and
    ``fits``, whether the shared memory is within ``_kernels.SMEM_LIMIT``, the
    H100's 227 KB a block (a launch beyond it is refused).  On the card
    (``device`` None or CUDA) also ``blocks_per_sm`` from the occupancy
    API, and the kernel's own host code must give the same shared memory;
    for a CPU ``device`` it is None.  ``kr + r`` above :data:`MAX_RIM`
    with the rim raises ``ValueError``."""
    if do_rim and not 0 <= int(kr) + int(r) <= MAX_RIM:
        raise ValueError(f"stage 1 takes kr + r in [0, {MAX_RIM}] with the rim")
    ring, smem, matches = _stage1_geometry(m, n, _round8(D), kr, r, do_rim)
    info = {"smem_bytes": smem, "ring_rows": ring, "blocks_per_sm": None,
            "matches_per_output": matches / (m * n), "fits": smem <= _kernels.SMEM_LIMIT}
    device = torch.device(device or "cuda")
    if device.type == "cpu":
        return info
    out = (ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong())
    with torch.cuda.device(device):
        err = _kernels.library().pst_chain_v_info(
            int(m), int(n), _round8(D), int(kr), int(r), int(bool(do_rim)),
            *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"pst_chain_v_info: CUDA error {err}")
    if (out[0].value, out[1].value, out[3].value) != (smem, ring, matches):
        raise AssertionError("stage 1's geometry differs from the kernel's")
    info["blocks_per_sm"] = out[2].value
    return info


def chain_horiz(C, disp_t, D, cval):
    """Stage 2 of the chain (replaces ``_k2_kernel``): the horizontal
    resample of ``C`` (B, m, n) with the out-of-domain fill, from the
    transposed planes ``disp_t`` (B, 2, n, m).  Reads ``C`` in place, where
    the TPU kernel reads an XLA transpose of it."""
    D = _round8(D)
    if not C.is_cuda:
        return _warp_h_plain(C, disp_t, D, cval)
    B, m, n = C.shape
    if disp_t.shape != (B, 2, n, m):
        raise ValueError("match_warp_rim: disp_t must be (B, 2, n, m)")
    _kernels.check_inputs("match_warp_rim", (C, disp_t), (torch.float32,) * 2)
    out = torch.empty_like(C)
    _kernels.launch(
        "pst_chain_h", C.device, C.data_ptr(), disp_t.data_ptr(),
        out.data_ptr(), B, m, n, D, float(cval),
    )
    _kernels.LAUNCHES["chain_horiz"] += 1
    return out


def _match_warp_rim_plain(field, e8, T, q0, zval, ztrg, thr, dy, disp_t, cval,
                          D, kr, r, do_rim):
    """Plain version of the chain: K3's map, then K2's masked warp and
    K4's rim of the matched field."""
    scal = _scalars(field.shape[0], q0, zval, ztrg)
    C, rim = _chain_v_plain(
        field, e8, T, *scal.unbind(1), thr, dy, _round8(D), kr, r, do_rim
    )
    return _warp_h_plain(C, disp_t, _round8(D), cval), rim


def match_warp_rim(field, e8, T, q0, zval, ztrg, thr, dy, disp_t, cval, D,
                   kr, r, do_rim=True):
    """The fused chain (replaces ``match_warp_rim``) on a (B, m, n) masked
    forecast: ``e8`` (B, 8) and ``T`` (B, 8, 48) from
    ``pallas_histmatch.pack_gather_lut``, ``q0``/``zval``/``ztrg`` (B,),
    ``dy`` (B, m, n) the vertical displacement, ``disp_t`` (B, 2, n, m) the
    transposed (dx, dy) planes, ``thr``/``cval`` floats, ``D`` the
    displacement bound (rounded up to a multiple of 8).  Returns
    ``(warped, rim)``; the rim is zeros when ``do_rim`` is False.  Two
    launches on the card: :func:`chain_match_vert_rim`, :func:`chain_horiz`."""
    C, rim = chain_match_vert_rim(
        field, e8, T, q0, zval, ztrg, thr, dy, D, kr, r, do_rim
    )
    return chain_horiz(C, disp_t, D, cval), rim
