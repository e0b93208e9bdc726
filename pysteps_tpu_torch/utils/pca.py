"""
Principal-component transform of an ensemble (counterpart of
``pysteps_tpu/utils/pca.py``), used by the reduced-space EnKF.

The fit is the economy SVD of the centred (n_ens, n_features) matrix,
which reproduces ``sklearn.decomposition.PCA(svd_solver="full")`` up to
each component's sign; the transforms are matmuls.  With ``mesh`` the fit
is the Gram trick with the feature axis sharded over the mesh
(:func:`_fit_pca_sharded`).
"""

import torch
from torch.distributed.device_mesh import DeviceMesh

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.ops.conv import ieee_fp32
from pysteps_tpu_torch.parallel.mesh import (
    AXES,
    all_gather_cat,
    all_reduce,
    axis_index,
    axis_size,
)


def _fit_pca_sharded(Xc, mesh):
    """PCA fit of the centred (n_ens, n_features) ``Xc`` by the Gram trick
    with the feature axis sharded over the mesh's "y" dimension (its first
    where "y" has one rank), padded with zeros to divide: ``G = Xc Xcᵀ`` is
    an ``all_reduce`` of each rank's (n_ens, n_ens) product, the small
    ``eigh`` is replicated (descending, eigenvalues clamped at 0), and the
    components come from one more product a rank, gathered.  Equals the
    SVD fit up to each component's sign on every component with variance,
    in IEEE float32 (no TF32).  A component whose eigenvalue is within
    rounding of 0 (below eps x the largest) is divided by the square root
    of that floor, where the JAX package divides by sqrt(1e-30) once
    rounding puts the eigenvalue at or below 0: its length then stays at
    rounding, where JAX's can reach 1e10 and the EnKF's analysis 1e20.
    Returns (components (n_ens, n_features), variances (n_ens,))."""
    axis = "y" if axis_size(mesh, "y") > 1 else AXES[0]
    n_sh = axis_size(mesh, axis)
    n_ens, n_feat = Xc.shape
    f_loc = -(-n_feat // n_sh)
    Xp = torch.cat([Xc, Xc.new_zeros((n_ens, f_loc * n_sh - n_feat))], dim=1)
    i0 = axis_index(mesh, axis) * f_loc
    xl = Xp[:, i0 : i0 + f_loc]
    with ieee_fp32():
        G = all_reduce(xl @ xl.T, mesh, axis)
        lam, U = torch.linalg.eigh(G)
        lam = torch.clamp(torch.flip(lam, dims=(0,)), min=0.0)
        U = torch.flip(U, dims=(1,))
        # an eigenvalue within eigh's rounding of 0 (a centred ensemble's
        # last) scales its component by its own size, not by 1/1e-15: its
        # projection is rounding, which must stay small in the scores
        floor = torch.clamp(lam[0] * torch.finfo(lam.dtype).eps, min=1e-30)
        S = torch.sqrt(torch.maximum(lam, floor))
        Vt = all_gather_cat((U / S).T @ xl, mesh, axis, dim=1)[:, :n_feat]
    return Vt, lam / max(n_ens - 1, 1)


def pca_transform(forecast_ens, mask=None, pca_params=None, get_params=False,
                  mesh=None, device=None, **kwargs):
    """Project (n_ens, n_features) forecasts onto principal components.

    With ``mask`` (boolean, n_features) only the masked features enter the
    projection.  ``kwargs``: ``n_components`` (default n_ens),
    ``svd_solver`` (ignored: the full SVD always runs).  Returns the
    (n_ens, n_components) scores, and with ``get_params=True`` the
    ``pca_params`` dict (``principal_components``, ``mean``,
    ``explained_variance``) as well.  Runs on the input's device (numpy
    input on the card unless ``device`` says otherwise).  ``mesh`` (a
    ``parallel.make_mesh`` mesh of that device's type; every rank calls
    with the same input) fits by :func:`_fit_pca_sharded`."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a DeviceMesh (parallel.make_mesh)")
    X = as_device_tensor(forecast_ens, device, torch.float32)
    if X.ndim != 2:
        raise ValueError("Input array should be two-dimensional!")
    if mesh is not None and mesh.device_type != X.device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot fit a PCA on {X.device}")

    if pca_params is None:
        n_components = kwargs.get("n_components", X.shape[0])
        mean = X.mean(dim=0)
        if mesh is not None:
            Vt, var = _fit_pca_sharded(X - mean, mesh)
        else:
            _, S, Vt = torch.linalg.svd(X - mean, full_matrices=False)
            var = S**2 / max(X.shape[0] - 1, 1)
        if n_components is not None:
            Vt = Vt[:n_components]
        pca_params = {
            "principal_components": Vt,
            "mean": mean,
            "explained_variance": var / torch.clamp(var.sum(), min=1e-30),
        }
    else:
        if "principal_components" not in pca_params:
            raise KeyError("Output is not None but has no key 'principal_components'!")
        if "mean" not in pca_params:
            raise KeyError("Output is not None but has no key 'mean'!")
        if X.shape[1] != pca_params["mean"].shape[0]:
            raise ValueError("pca mean has not the same length as the input array!")
        if X.shape[1] != pca_params["principal_components"].shape[1]:
            raise ValueError(
                "principal components have not the same length as the input array"
            )
    comps = as_device_tensor(pca_params["principal_components"], X.device, torch.float32)
    mean = as_device_tensor(pca_params["mean"], X.device, torch.float32)
    if mask is None:
        transformed = (X - mean) @ comps.T
    else:
        mask = as_device_tensor(mask, X.device, torch.bool)
        transformed = (X[:, mask] - mean[mask]) @ comps[:, mask].T
    if get_params:
        return transformed, pca_params
    return transformed


def pca_backtransform(forecast_ens_pc, pca_params, device=None):
    """Inverse of :func:`pca_transform`: (n_ens, n_components) scores to
    (n_ens, n_features) fields."""
    Z = as_device_tensor(forecast_ens_pc, device, torch.float32)
    comps = as_device_tensor(pca_params["principal_components"], Z.device, torch.float32)
    mean = as_device_tensor(pca_params["mean"], Z.device, torch.float32)
    return Z @ comps + mean
