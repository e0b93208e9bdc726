"""
Backward-warp primitives of semi-Lagrangian advection
(counterpart of ``pysteps_tpu/ops/warp.py``).

Two families:

- the exact gathers (``nearest_warp``, ``bilinear_warp``, ``cubic_warp``
  and ``warp`` of order 0, 1 or 3): the path the JAX package takes on
  the CPU, and the port's path for CPU tensors and for orders 0 and 3;
- the shift-decomposition warp (``warp_shifted``, ``warp_shifted_multi``,
  ``sample_velocity_shifted``) with a static displacement bound: a
  vertical then a horizontal linear resample, each through kernel K1
  (``ops/pallas_warp.py::axis_resample``) — the path the JAX package
  takes on the TPU.

Every function takes fields with any leading batch axes ``(..., m, n)``
and displacements ``(..., 2, m, n)`` (x component first, as in the
reference's velocity layout); a field without the batch axes is
broadcast over them.
"""

import torch

# K1 and its plain version live beside each other in ops/pallas_warp.py;
# _axis_resample is exported here too, where the JAX package keeps it
from pysteps_tpu_torch.ops.pallas_warp import _axis_resample, axis_resample  # noqa: F401


def _grid(m, n, like):
    yy = torch.arange(m, dtype=like.dtype, device=like.device)[:, None]
    xx = torch.arange(n, dtype=like.dtype, device=like.device)[None, :]
    return yy, xx


def _sampler(field, coords_y):
    """(lead, gather) for sampling ``field`` (..., m, n) at coordinates
    shaped like ``coords_y``: ``gather(yi, xi)`` reads the edge-clamped
    integer positions (lead + (h, w)) of every leading index."""
    m, n = field.shape[-2:]
    lead = torch.broadcast_shapes(field.shape[:-2], coords_y.shape[:-2])
    flat = field.expand(lead + (m, n)).reshape(-1, m * n)

    def gather(yi, xi):
        idx = torch.clamp(yi, 0, m - 1) * n + torch.clamp(xi, 0, n - 1)
        return torch.gather(flat, 1, idx.reshape(flat.shape[0], -1)).reshape(yi.shape)

    return lead, gather


def _fill_outside(out, cy, cx, m, n, mode, cval):
    """scipy's "constant" rule: samples outside [0, m-1] x [0, n-1] take
    ``cval``; "nearest" keeps the edge-clamped value."""
    if mode == "constant":
        inside = (cy >= 0) & (cy <= m - 1) & (cx >= 0) & (cx <= n - 1)
        out = torch.where(inside, out, float(cval))
    return out


def bilinear_warp(field, coords_y, coords_x, mode="constant", cval=float("nan")):
    """Sample ``field`` (..., m, n) at fractional coordinates (..., h, w),
    by default the field's own grid (h, w) = (m, n).  mode "constant"
    fills samples outside [0, m-1] x [0, n-1] with ``cval``; "nearest"
    clamps to the edge."""
    m, n = field.shape[-2:]
    lead, gather = _sampler(field, coords_y)
    cy = coords_y.expand(lead + coords_y.shape[-2:])
    cx = coords_x.expand(lead + coords_y.shape[-2:])
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    wy = cy - y0
    wx = cx - x0
    y0i = y0.long()
    x0i = x0.long()
    f00 = gather(y0i, x0i)
    f01 = gather(y0i, x0i + 1)
    f10 = gather(y0i + 1, x0i)
    f11 = gather(y0i + 1, x0i + 1)
    top = f00 * (1.0 - wx) + f01 * wx
    bot = f10 * (1.0 - wx) + f11 * wx
    out = top * (1.0 - wy) + bot * wy
    return _fill_outside(out, cy, cx, m, n, mode, cval)


def nearest_warp(field, coords_y, coords_x, mode="constant", cval=float("nan")):
    """Nearest-neighbour sampling (``interp_order=0``): coordinates round
    half to even, and "constant" tests the rounded position."""
    m, n = field.shape[-2:]
    lead, gather = _sampler(field, coords_y)
    yi = torch.round(coords_y.expand(lead + (m, n))).long()
    xi = torch.round(coords_x.expand(lead + (m, n))).long()
    return _fill_outside(gather(yi, xi), yi, xi, m, n, mode, cval)


def _catmull_rom_weights(t):
    """Catmull-Rom cubic weights of the 4 taps around fraction ``t``."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def cubic_warp(field, coords_y, coords_x, mode="constant", cval=float("nan")):
    """Catmull-Rom bicubic sampling (``interp_order=3``) over the 4 x 4
    edge-clamped taps around each position; "constant" tests the
    fractional position, as the bilinear warp does."""
    m, n = field.shape[-2:]
    lead, gather = _sampler(field, coords_y)
    cy = coords_y.expand(lead + (m, n))
    cx = coords_x.expand(lead + (m, n))
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    wy = _catmull_rom_weights(cy - y0)
    wx = _catmull_rom_weights(cx - x0)
    y0i = y0.long()
    x0i = x0.long()
    out = torch.zeros_like(cy)
    for a in range(4):
        row = torch.zeros_like(cy)
        for b in range(4):
            row = row + wx[b] * gather(y0i + a - 1, x0i + b - 1)
        out = out + wy[a] * row
    return _fill_outside(out, cy, cx, m, n, mode, cval)


def warp(field, displacement, order=1, mode="constant", cval=float("nan")):
    """Exact backward warp of ``field`` by ``displacement`` (..., 2, m, n):
    order 0 nearest, 1 bilinear, 3 Catmull-Rom bicubic."""
    m, n = field.shape[-2:]
    yy, xx = _grid(m, n, displacement)
    cy = yy + displacement[..., 1, :, :]
    cx = xx + displacement[..., 0, :, :]
    if order == 0:
        return nearest_warp(field, cy, cx, mode=mode, cval=cval)
    if order == 3:
        return cubic_warp(field, cy, cx, mode=mode, cval=cval)
    return bilinear_warp(field, cy, cx, mode=mode, cval=cval)


def _coords(displacement):
    """Integer cells and fractions of the displaced sampling positions."""
    m, n = displacement.shape[-2:]
    yy, xx = _grid(m, n, displacement)
    cy = yy + displacement[..., 1, :, :]
    cx = xx + displacement[..., 0, :, :]
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    return cy, cx, y0.int(), cy - y0, x0.int(), cx - x0


def warp_shifted_multi(fields, displacement, max_disp, mode="constant", cval=float("nan")):
    """Shift-decomposition warp of C fields (..., C, m, n) sharing one
    displacement (..., 2, m, n): vertical resample at the original
    columns, then horizontal resample, each one K1 launch for the whole
    batch.  |displacement| is clamped to ``max_disp``."""
    m, n = fields.shape[-2:]
    lead = displacement.shape[:-3]
    C = fields.shape[-3]
    fields = fields.expand(lead + (C, m, n)).reshape(-1, m, n).contiguous()
    cy, cx, y0i, wy, x0i, wx = _coords(displacement)
    y0i, wy = y0i.reshape(-1, m, n), wy.reshape(-1, m, n)
    x0i, wx = x0i.reshape(-1, m, n), wx.reshape(-1, m, n)
    D = int(max_disp)
    out = axis_resample(fields, y0i.contiguous(), wy.contiguous(), D, 0)
    out = axis_resample(out, x0i.contiguous(), wx.contiguous(), D, 1)
    out = out.reshape(lead + (C, m, n))
    if mode == "constant":
        inside = (cy >= 0) & (cy <= m - 1) & (cx >= 0) & (cx <= n - 1)
        out = torch.where(inside[..., None, :, :], out, float(cval))
    return out


def warp_shifted(field, displacement, max_disp, mode="constant", cval=float("nan")):
    """Single-channel :func:`warp_shifted_multi`."""
    return warp_shifted_multi(
        field[..., None, :, :], displacement, max_disp, mode=mode, cval=cval
    )[..., 0, :, :]


_upsample_mats = {}


def _bilinear_upsample_matrix(n_out, n_in):
    """2-banded interpolation matrix of the bilinear upscale with
    half-pixel centres and edge clamping (what ``jax.image.resize`` and
    ``F.interpolate(align_corners=False)`` compute when upscaling)."""
    scale = n_out / n_in
    i = torch.arange(n_out, dtype=torch.float64)
    src = (i + 0.5) / scale - 0.5
    lo = torch.floor(src).long()
    w = (src - lo).float()
    U = torch.zeros(n_out, n_in, dtype=torch.float32)
    rows = torch.arange(n_out)
    U.index_put_((rows, torch.clamp(lo, 0, n_in - 1)), 1.0 - w, accumulate=True)
    U.index_put_((rows, torch.clamp(lo + 1, 0, n_in - 1)), w, accumulate=True)
    return U


def upsample_matrices(m, mc, n, nc, device):
    """(Uy (m, mc), Ux (n, nc)) on ``device``, cached per shape and device."""
    key = (m, mc, n, nc, str(device))
    if key not in _upsample_mats:
        _upsample_mats[key] = (
            _bilinear_upsample_matrix(m, mc).to(device),
            _bilinear_upsample_matrix(n, nc).to(device),
        )
    return _upsample_mats[key]


def bilinear_upsample(x, shape):
    """Bilinear upscale of (..., mc, nc) to (..., m, n)."""
    m, n = shape
    mc, nc = x.shape[-2:]
    Uy, Ux = upsample_matrices(m, mc, n, nc, x.device)
    return torch.einsum("ya,...ab,xb->...yx", Uy, x, Ux)


def block_mean(x, coarse):
    """Mean over coarse x coarse blocks of (..., m, n)."""
    m, n = x.shape[-2:]
    x = x.reshape(x.shape[:-2] + (m // coarse, coarse, n // coarse, coarse))
    return x.mean(dim=(-3, -1))


def sample_velocity_shifted(velocity, displacement, max_disp, coarse=4):
    """Edge-clamped bilinear sampling of a (..., 2, m, n) velocity field at
    displaced positions with the shift-decomposition warp; with
    ``coarse`` > 1 on a block-averaged grid, bilinearly upsampled back."""
    m, n = velocity.shape[-2:]
    if coarse > 1 and m % coarse == 0 and n % coarse == 0:
        vel_c = block_mean(velocity, coarse)
        disp_c = block_mean(displacement, coarse) / coarse
        Dc = max(int(-(-max_disp // coarse)), 1)
        s = warp_shifted_multi(vel_c, disp_c, Dc, mode="nearest")
        return bilinear_upsample(s, (m, n))
    return warp_shifted_multi(velocity, displacement, max_disp, mode="nearest")
