"""
Distributed 2-D real FFT over a row-sharded grid (counterpart of
``pysteps_tpu/parallel/dist_fft.py``).

For a grid whose rows are sharded over the mesh's "y" dimension the
pencil decomposition applies: the real FFT along x is local to the rows,
one all-to-all transposes the blocks so that spectral columns become
local, and the complex FFT along y is local to the columns.  The spectrum
stays column-sharded; the inverse runs the same pipeline backwards.  The
functions take this rank's block (with leading batch axes) and the mesh.

Complex blocks travel as two float32 lanes (``torch.view_as_real``), as
the JAX package splits them (TPU collectives move f32).
"""

import torch
import torch.distributed as dist

from pysteps_tpu_torch.parallel.mesh import axis_index, axis_size, mesh_device


def _all_to_all(x, mesh, axis_name, split_dim, concat_dim):
    """Split ``x`` into equal blocks along ``split_dim``, send block j to
    rank j along ``axis_name`` and concatenate the received blocks along
    ``concat_dim`` in rank order (``all_to_all(..., tiled=True)``);
    ``mesh=None`` is one block, which stays."""
    if mesh is None:
        return x
    size = axis_size(mesh, axis_name)
    send = torch.stack(torch.tensor_split(x, size, dim=split_dim))
    lanes = torch.view_as_real(send) if send.is_complex() else send
    lanes = lanes.contiguous()
    recv = torch.empty_like(lanes)
    dist.all_to_all_single(recv, lanes, group=mesh.get_group(axis_name))
    if send.is_complex():
        recv = torch.view_as_complex(recv)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _ceil_to(v, mult):
    return ((v + mult - 1) // mult) * mult


def rfft2_local(f_rows, mesh, axis_name="y"):
    """rfft2 of a global (..., m, n) field from this rank's (..., m_loc, n)
    row block.  Returns the rank's (..., m, c_loc) column block of the
    (..., m, n//2+1) spectrum, its columns padded with zeros to a multiple
    of the shard count (:func:`spec_cols`)."""
    size = axis_size(mesh, axis_name)
    n = f_rows.shape[-1]
    c = n // 2 + 1
    c_pad = _ceil_to(c, size)
    fx = torch.fft.rfft(f_rows, dim=-1)
    pad = fx.new_zeros(fx.shape[:-1] + (c_pad - c,))
    fx = torch.cat([fx, pad], dim=-1)
    ft = _all_to_all(fx, mesh, axis_name, split_dim=-1, concat_dim=-2)
    return torch.fft.fft(ft, dim=-2)


def irfft2_local(spec_cols, shape, mesh, axis_name="y"):
    """Inverse of :func:`rfft2_local`: this rank's (..., m, c_loc) spectral
    columns to its (..., m_loc, n) rows of the (m, n) field."""
    n = shape[1]
    c = n // 2 + 1
    fy = torch.fft.ifft(spec_cols, dim=-2)
    fx = _all_to_all(fy, mesh, axis_name, split_dim=-2, concat_dim=-1)
    return torch.fft.irfft(fx[..., :c], n=n, dim=-1)


def spec_cols(n, size):
    """Local spectral-column count for a width-n grid on ``size`` shards."""
    return _ceil_to(n // 2 + 1, size) // size


def _local_cols(n, size, mesh, axis_name):
    c_loc = spec_cols(n, size)
    dev = None if mesh is None else mesh_device(mesh)
    return axis_index(mesh, axis_name) * c_loc + torch.arange(c_loc, device=dev)


def spec_col_mask(n, size, mesh, axis_name="y"):
    """Validity mask (c_loc,) of this rank's spectral columns (the column
    padding of :func:`rfft2_local` is invalid)."""
    return _local_cols(n, size, mesh, axis_name) < n // 2 + 1


def spec_weight_local(n, size, mesh, axis_name="y"):
    """Parseval weights (c_loc,) of this rank's spectral columns: interior
    rfft2 columns count twice (conjugate half-plane), the DC and Nyquist
    columns once, padded columns zero."""
    c = n // 2 + 1
    cols = _local_cols(n, size, mesh, axis_name)
    edge = (cols == 0) | (cols == (c - 1 if n % 2 == 0 else -1))
    w = torch.where(edge, 1.0, 2.0)
    return torch.where(cols < c, w, 0.0)
