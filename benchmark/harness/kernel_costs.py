"""The least operations and bytes of each hand-written kernel launch, and
the card's published peaks.

Counts follow ``PERF.md``'s kernel table: each input byte read once, each
output byte written once (scratch planes and reads of a tap again are
not counted), and the operations an output pixel needs at the least.
Each function takes the launch's arguments as ``ops/_kernels.launch``
receives them after the entry's name and device (pointers, then sizes;
the stream is not among them).  LUT sizes are the port's packed layouts:
``e8`` (B, 8) and ``T`` (B, 8, 48) for the gathered PWL map, ``e16``
(B, 16) and ``M3`` (B, 72, 16) for the hierarchical one, ``edges`` (B, 128)
and ``w`` (B, 8, 128) for the flat one, and a (B, 3) block of scalars.
"""

F32 = 4
LUT_GATHER = (8 + 8 * 48 + 3) * F32      # e8, T, scalars: a member
LUT_HIER = (16 + 72 * 16 + 3) * F32      # e16, M3, scalars
LUT_FLAT = (128 + 8 * 128 + 1) * F32     # edges, w, q0
MATCH_OPS = 8 + 2 + 1  # 8 compares among sorted edges, a multiply-add, the dry override
LERP_OPS = 3
RIM_OPS = 2

# memory rate (bytes/s) and float32 rate outside the tensor cores (FLOP/s),
# from NVIDIA's data sheets; the SXM part's figures are the default
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),
}


def peaks(device_name):
    """(bytes/s, FLOP/s) of the card named ``device_name``."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return PEAKS["H100"]


def _resample(field, idx0, frac, out, B, rep, m, n, D, axis):
    px = B * m * n
    return LERP_OPS * px, 2 * F32 * px + 2 * F32 * (B // rep) * m * n


def _warp(field, dy, disp_t, scratch, out, B, m, n, *rest):
    px = B * m * n
    return (2 * LERP_OPS + 2) * px, 5 * F32 * px  # field, dy, (dx, dy) planes, out


def _pwl_gather(x, e8, T, scal, out, B, N):
    return MATCH_OPS * B * N, 2 * F32 * B * N + B * LUT_GATHER


def _pwl_hier(x, e16, M3, scal, out, B, N):
    return MATCH_OPS * B * N, 2 * F32 * B * N + B * LUT_HIER


def _pwl_flat(x, edges, w, q0, out, B, N):
    return MATCH_OPS * B * N, 2 * F32 * B * N + B * LUT_FLAT


def _rim(x, is_bytes, thr, strict, scratch, out, B, m, n, kr, r):
    px = B * m * n
    return RIM_OPS * px, (1 if is_bytes else F32) * px + F32 * px


def _chain_v(field, e8, T, scal, dy, C, mask, B, m, n, D, kr, r, thr, do_rim):
    px = B * m * n
    planes = 4 if do_rim else 3  # field and dy read; C (and the rim) written
    ops = MATCH_OPS + LERP_OPS + (RIM_OPS if do_rim else 0)
    return ops * px, planes * F32 * px + B * LUT_GATHER


def _chain_h(C, disp_t, out, B, m, n, D, cval):
    px = B * m * n
    return (LERP_OPS + 1) * px, 4 * F32 * px  # C, (dx, dy) planes, out


def _cdf_counts(x, edges, work, out, B, N):
    return 9 * B * N, F32 * B * N + 2 * B * 128 * F32  # pixels and edges read, counts written


COSTS = {
    "pst_resample": _resample,
    "pst_warp": _warp,
    "pst_pwl_gather": _pwl_gather,
    "pst_pwl_hier": _pwl_hier,
    "pst_pwl_flat": _pwl_flat,
    "pst_rim": _rim,
    "pst_chain_v": _chain_v,
    "pst_chain_h": _chain_h,
    "pst_cdf_counts": _cdf_counts,
}


def least_seconds(entry, args, device_name):
    """The least time of one launch of C entry ``entry`` with ``args``:
    the larger of its bytes over the memory rate and its operations over
    the float32 rate.  Returns (seconds, "bytes" or "ops")."""
    ops, nbytes = COSTS[entry](*args)
    bw, flops = peaks(device_name)
    t_bytes, t_ops = nbytes / bw, ops / flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
