"""
Principal-component transform of an ensemble (counterpart of
``pysteps_tpu/utils/pca.py``), used by the reduced-space EnKF.

The fit is the economy SVD of the centred (n_ens, n_features) matrix,
which reproduces ``sklearn.decomposition.PCA(svd_solver="full")`` up to
each component's sign; the transforms are matmuls.  Not ported (it raises
``NotImplementedError``): ``mesh``, the feature-sharded fit, which comes
with the port's ``parallel`` package.
"""

import torch

from pysteps_tpu_torch._device import as_device_tensor


def pca_transform(forecast_ens, mask=None, pca_params=None, get_params=False,
                  mesh=None, device=None, **kwargs):
    """Project (n_ens, n_features) forecasts onto principal components.

    With ``mask`` (boolean, n_features) only the masked features enter the
    projection.  ``kwargs``: ``n_components`` (default n_ens),
    ``svd_solver`` (ignored: the full SVD always runs).  Returns the
    (n_ens, n_components) scores, and with ``get_params=True`` the
    ``pca_params`` dict (``principal_components``, ``mean``,
    ``explained_variance``) as well.  Runs on the input's device (numpy
    input on the card unless ``device`` says otherwise)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh is not ported yet (ROADMAP A12b: the feature-sharded PCA fit)"
        )
    X = as_device_tensor(forecast_ens, device, torch.float32)
    if X.ndim != 2:
        raise ValueError("Input array should be two-dimensional!")

    if pca_params is None:
        n_components = kwargs.get("n_components", X.shape[0])
        mean = X.mean(dim=0)
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
