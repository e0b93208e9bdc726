"""
Row-sharded advection with halo exchange (counterpart of
``pysteps_tpu/parallel/halo.py``).

For grids too large for one device, the radar domain shards its rows over
the mesh's "y" dimension and the semi-Lagrangian gather needs rows of the
neighbouring shards.  With the displacement bounded by ``halo`` (the
static bound of the shift-decomposition warp), each rank swaps ``halo``
boundary rows with its neighbours (``batch_isend_irecv``) and warps its
extended block locally through ``ops/warp.warp_shifted`` (kernel K1 on
the card).
"""

import torch
import torch.distributed as dist

from pysteps_tpu_torch.ops.warp import warp_shifted
from pysteps_tpu_torch.parallel.mesh import (
    all_gather_cat,
    axis_index,
    axis_size,
    mesh_device,
)


def _edge(rows, halo):
    """``halo`` copies of a one-row slice (..., 1, n)."""
    return rows.expand(rows.shape[:-2] + (halo, rows.shape[-1]))


def _exchange_halos(f_local, halo, mesh, axis_name="y"):
    """This rank's rows (..., m_loc, n) with ``halo`` rows of the previous
    and the next rank along ``axis_name`` above and below; the shards at
    the domain's edge replicate their own boundary row.  A halo of the
    block's height or more cannot come from the nearest neighbours alone:
    then every rank gathers the whole column and slices.  ``mesh=None`` is
    one block, extended by its own edge rows."""
    idx = axis_index(mesh, axis_name)
    size = axis_size(mesh, axis_name)
    m_loc = f_local.shape[-2]
    if halo >= m_loc:
        full = all_gather_cat(f_local, mesh, axis_name, dim=-2)
        padded = torch.cat(
            [_edge(full[..., :1, :], halo), full, _edge(full[..., -1:, :], halo)], dim=-2
        )
        return padded[..., idx * m_loc : idx * m_loc + m_loc + 2 * halo, :]
    top = _edge(f_local[..., :1, :], halo)
    bottom = _edge(f_local[..., -1:, :], halo)
    ops = []
    group = None if size == 1 else mesh.get_group(axis_name)
    if idx > 0:
        prev = dist.get_global_rank(group, idx - 1)
        top = torch.empty_like(top, memory_format=torch.contiguous_format)
        ops += [dist.P2POp(dist.isend, f_local[..., :halo, :].contiguous(), prev, group),
                dist.P2POp(dist.irecv, top, prev, group)]
    if idx < size - 1:
        nxt = dist.get_global_rank(group, idx + 1)
        bottom = torch.empty_like(bottom, memory_format=torch.contiguous_format)
        ops += [dist.P2POp(dist.isend, f_local[..., -halo:, :].contiguous(), nxt, group),
                dist.P2POp(dist.irecv, bottom, nxt, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top, f_local, bottom], dim=-2)


def _local_rows(x, mesh, axis_name="y"):
    """This rank's block of the rows (axis -2) of a global array."""
    x = torch.as_tensor(x, device=mesh_device(mesh))
    size = axis_size(mesh, axis_name)
    m = x.shape[-2]
    if m % size:
        raise ValueError(f"rows {m} not divisible by {axis_name} shards {size}")
    m_loc = m // size
    i0 = axis_index(mesh, axis_name) * m_loc
    return x[..., i0 : i0 + m_loc, :]


def _pad_rows(d, halo):
    """Edge-replicate ``halo`` rows above and below (..., m, n)."""
    return torch.cat([_edge(d[..., :1, :], halo), d, _edge(d[..., -1:, :], halo)], dim=-2)


def _inside(disp, row0, m_glob):
    """Whether each displaced position of a row block (2, m_loc, n) starting
    at global row ``row0`` lies inside the global (m_glob, n) domain."""
    m_loc, n = disp.shape[-2:]
    gy = row0 + torch.arange(m_loc, device=disp.device, dtype=torch.int32)[:, None]
    gx = torch.arange(n, device=disp.device, dtype=torch.int32)[None, :]
    cy = gy.to(disp.dtype) + disp[..., 1, :, :]
    cx = gx.to(disp.dtype) + disp[..., 0, :, :]
    return (cy >= 0) & (cy <= m_glob - 1) & (cx >= 0) & (cx <= n - 1)


def sharded_warp(field, displacement, mesh, max_disp, cval=0.0):
    """Backward-warp a global (m, n) field with its rows sharded over the
    mesh's "y" dimension.

    Equivalent to ``warp_shifted(field, displacement, max_disp)``: each rank
    takes its rows, exchanges ``max_disp`` halo rows with its neighbours,
    resamples its extended block and fills ``cval`` outside the global
    domain; one all-gather returns the global result to every rank."""
    halo = int(max_disp)
    f_local = _local_rows(field, mesh).to(torch.float32)
    d_local = _local_rows(displacement, mesh).to(torch.float32)
    extended = _exchange_halos(f_local, halo, mesh, "y")
    # the displacement rows of the halo only feed outputs that are cut away
    out = warp_shifted(extended, _pad_rows(d_local, halo), halo, mode="nearest")
    out = out[..., halo:-halo, :]
    m_loc = f_local.shape[-2]
    row0 = axis_index(mesh, "y") * m_loc
    out = torch.where(_inside(d_local, row0, axis_size(mesh, "y") * m_loc), out, float(cval))
    return all_gather_cat(out, mesh, "y", dim=-2)
