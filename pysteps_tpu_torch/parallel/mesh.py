"""
Device meshes and member placement on ``torch.distributed`` (counterpart
of ``pysteps_tpu/parallel/mesh.py``).

The JAX package is single-controller SPMD: one process shards global
arrays over a ``Mesh("ens", "y", "x")``.  The port is multi-process SPMD,
one rank a device: every rank calls the same entry point with the same
global inputs, computes its own block and gets the global result back
through an all-gather.  A mesh is a ``DeviceMesh`` whose dimensions are
named ("ens", "y", "x"); ensemble members split over "ens" (they never
communicate until the gather), grid rows over "y" (halo exchange and the
distributed FFT).  The card runs on ``nccl``, the CPU on ``gloo``.
"""

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pysteps_tpu_torch._device import resolve_device

AXES = ("ens", "y", "x")


def _backend(device_type):
    return "nccl" if device_type == "cuda" else "gloo"


def _init_default_group(device_type):
    """The default process group: the one that exists, else one made from
    the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) with the device type's backend.  An existing group of
    another backend is refused, never swapped."""
    backend = _backend(device_type)
    if dist.is_initialized():
        if backend not in str(dist.get_backend()):
            raise RuntimeError(
                f"a {device_type} mesh needs the {backend} backend; the default "
                f"process group uses {dist.get_backend()}"
            )
        return
    dist.init_process_group(backend, init_method="env://")
    print(f"make_mesh: initialized the default process group with the {backend} "
          f"backend ({dist.get_world_size()} ranks)")


def _set_cuda_device():
    n = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % max(n, 1)))
    torch.cuda.set_device(local)


def make_mesh(ens=None, y=1, x=1, device_type="cuda"):
    """A ``DeviceMesh`` with dimensions ("ens", "y", "x") over the first
    ens * y * x ranks; ``ens=None`` takes world size / (y x).  Every rank
    of the default group calls it (ranks beyond the mesh get a mesh they
    are not part of: ``mesh.get_coordinate()`` is None).  A CUDA mesh
    raises ``RuntimeError`` where no card is available."""
    if device_type == "cuda":
        resolve_device("cuda")
    _init_default_group(device_type)
    world = dist.get_world_size()
    if ens is None:
        ens = world // (y * x)
    if ens * y * x > world or ens < 1:
        raise ValueError(f"mesh {ens}x{y}x{x} needs {ens * y * x} ranks, have {world}")
    if device_type == "cuda":
        _set_cuda_device()
    ranks = torch.arange(ens * y * x).reshape(ens, y, x)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def make_mesh_multihost(y=1, x=1, device_type="cuda"):
    """Node-major mesh for several hosts: "ens" runs across hosts (members
    never communicate, so the slow link carries only the final gather) and
    "y"/"x" within a host, whose ranks share the fast link.  Ranks are
    numbered node-major (``torchrun`` numbers them so), which makes each
    (y, x) block one host's ranks when y x divides the ranks of a host
    (``LOCAL_WORLD_SIZE``).  On one host this is :func:`make_mesh`."""
    if device_type == "cuda":
        resolve_device("cuda")
    _init_default_group(device_type)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if y * x > local:
        raise ValueError(f"spatial axes y*x={y * x} exceed local device count {local}")
    if local % (y * x):
        raise ValueError(f"y*x={y * x} does not divide the {local} ranks of a host")
    return make_mesh(ens=dist.get_world_size() // (y * x), y=y, x=x, device_type=device_type)


def axis_size(mesh, name):
    """Number of ranks along the mesh dimension ``name`` (1 for
    ``mesh=None``, one block of the whole problem)."""
    return 1 if mesh is None else mesh.size(AXES.index(name))


def axis_index(mesh, name):
    """This rank's coordinate along the mesh dimension ``name`` (0 for
    ``mesh=None``)."""
    return 0 if mesh is None else mesh.get_local_rank(name)


def mesh_device(mesh):
    """The device of this rank's tensors: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def ens_sharding(mesh):
    """Placements that split the leading (member) axis over "ens" and
    replicate over "y" and "x" (``torch.distributed.tensor``'s form of
    ``P("ens")``)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate(), Replicate())


def replicated(mesh):
    """Placements that replicate over every mesh dimension."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate(), Replicate())


def member_block(n, mesh, axis_name="ens"):
    """(start, stop) of this rank's block of ``n`` items (members, cases)
    split over the mesh dimension ``axis_name`` (all of them for
    ``mesh=None``)."""
    size = axis_size(mesh, axis_name)
    if n % size:
        raise ValueError(f"{n} items not divisible by {axis_name} shards {size}")
    block = n // size
    start = axis_index(mesh, axis_name) * block
    return start, start + block


def shard_ensemble(tree, mesh):
    """This rank's member block of every tensor or array with a leading
    member axis in a (nested dict, list or tuple) tree, as tensors on the
    rank's device."""
    if mesh is None:
        return tree
    dev = mesh_device(mesh)

    def place(a):
        if isinstance(a, dict):
            return {k: place(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(place(v) for v in a)
        t = torch.as_tensor(a, device=dev)
        start, stop = member_block(t.shape[0], mesh)
        return t[start:stop]

    return place(tree)


def all_reduce(x, mesh, name, op=dist.ReduceOp.SUM):
    """``x`` reduced over the mesh dimension ``name`` (a new tensor);
    ``mesh=None`` is one block of the whole problem, with nothing to
    reduce (the callers' math then runs without a process group)."""
    if mesh is None:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=mesh.get_group(name))
    return x


def all_gather_cat(t, mesh, name, dim=0):
    """Concatenate every rank's ``t`` along ``dim`` over the mesh
    dimension ``name``, in rank order (one all-gather); ``mesh=None``
    returns ``t``."""
    if mesh is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, name))]
    dist.all_gather(parts, t, group=mesh.get_group(name))
    return torch.cat(parts, dim=dim)
