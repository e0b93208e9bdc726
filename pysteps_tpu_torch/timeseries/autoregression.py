"""AR(p) and VAR(p) estimation and iteration (counterpart of
``pysteps_tpu/timeseries/autoregression.py``).

Fits run once at init: Yule-Walker and OLS solves of small systems, batched
over leading axes (levels, pixels) with ``torch.linalg.solve``; the
localized fits weight their normal equations with a moving window
(separable convolutions).  The stationarity tests run on the host in
numpy.  The iterations broadcast over leading batch axes.  Every fit and
iteration runs on the device of its tensor inputs; input that is not a
tensor goes to the card unless ``device`` says otherwise.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.timeseries.correlation import _sep_conv2d, _window_kernel


def _t(x, device):
    """``x`` as a tensor on ``device`` (float32 where it is not a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def adjust_lag2_corrcoef1(gamma_1, gamma_2, device=None):
    """Simple stationarity clamp of the lag-2 coefficient."""
    dev = resolve_device(device, gamma_1, gamma_2)
    gamma_1, gamma_2 = _t(gamma_1, dev), _t(gamma_2, dev)
    gamma_2 = torch.maximum(gamma_2, 2 * gamma_1 * gamma_1 - 1 + 1e-10)
    return torch.minimum(gamma_2, torch.tensor(1 - 1e-10, dtype=gamma_2.dtype,
                                               device=gamma_2.device))


def adjust_lag2_corrcoef2(gamma_1, gamma_2):
    """Stationarity clamp of the lag-2 coefficient; gamma_1 is clipped into
    (-1, 1) so that (1 - gamma_1^2)^1.5 stays real."""
    gamma_1 = torch.clamp(gamma_1, -0.9999, 0.9999)
    gamma_2 = torch.maximum(gamma_2, 2 * gamma_1 * gamma_2 - 1)
    gamma_2 = torch.maximum(
        gamma_2,
        (3 * gamma_1**2 - 2 + 2 * (1 - gamma_1**2) ** 1.5)
        / torch.clamp(gamma_1**2, min=1e-8),
    )
    return gamma_2


def estimate_ar_params_yw(gamma, d=0, check_stationarity=True, device=None):
    """Yule-Walker AR(p) fit from lag autocorrelations ``gamma`` (..., p).
    Returns (..., p+1): phi_1..phi_p and the innovation coefficient
    sqrt(1 - sum gamma_j phi_j); with ``d=1`` the ARI(p, 1) coefficients
    on the undifferenced series (p+1 of them) before it.  The stationarity
    check (``RuntimeError``) applies to a single fit (1-D ``gamma``)."""
    if d not in (0, 1):
        raise ValueError(f"d = {d}, but 0 or 1 required")
    # keep the Toeplitz system non-singular at |gamma| == 1
    gamma = torch.clamp(_t(gamma, resolve_device(device, gamma)), -0.9985, 0.9985)
    p = gamma.shape[-1]
    g = torch.cat([torch.ones_like(gamma[..., :1]), gamma], dim=-1)
    idx = torch.as_tensor(
        np.abs(np.subtract.outer(np.arange(p), np.arange(p))), device=gamma.device
    )
    G = g[..., idx]
    phi = torch.linalg.solve(G, gamma[..., None])[..., 0]
    if check_stationarity and gamma.ndim == 1:
        if not test_ar_stationarity(phi.detach().cpu().numpy()):
            raise RuntimeError("nonstationary AR(p) process")
    c = 1.0 - torch.sum(gamma * phi, dim=-1)
    phi_pert = torch.sqrt(torch.clamp(c, min=0.0))
    if d == 1:
        phi = _differenced_to_undifferenced(phi)
    return torch.cat([phi, phi_pert[..., None]], dim=-1)


def estimate_ar_params_yw_localized(gamma, d=0, device=None):
    """Per-pixel Yule-Walker fit from a list or stack of p (m, n) lag maps.
    Returns (p+1, m, n)."""
    if isinstance(gamma, (list, tuple)):
        dev = resolve_device(device, *gamma)
        gamma = torch.stack([_t(g, dev) for g in gamma])
    else:
        gamma = _t(gamma, resolve_device(device, gamma))
    out = estimate_ar_params_yw(torch.movedim(gamma, 0, -1), d=d, check_stationarity=False)
    return torch.movedim(out, -1, 0)


def _differenced_to_undifferenced(phi):
    """AR parameters of the differenced series (..., p) as ARI(p, 1)
    parameters of the original series (..., p+1): the coefficients of
    (1 - sum phi_i B^i)(1 - B) on B^1..B^(p+1)."""
    p = phi.shape[-1]
    out = torch.zeros(phi.shape[:-1] + (p + 1,), dtype=phi.dtype, device=phi.device)
    out[..., 0] = 1.0 + phi[..., 0]
    if p > 1:
        out[..., 1:p] = phi[..., 1:] - phi[..., :-1]
    out[..., p] = -phi[..., p - 1]
    return out


def estimate_ar_params_ols(
    x, p, d=0, check_stationarity=True, include_constant_term=False, h=0, lam=0.0,
    device=None,
):
    """OLS AR(p) fit from a sample series x (n, ...); all pixels share the
    parameters.  Returns (p+1,): phi_1..phi_p (ARI(p, 1) with ``d=1``) and
    the residuals' standard deviation."""
    x = _t(x, resolve_device(device, x))
    if d == 1:
        x = torch.diff(x, dim=0)
    n = x.shape[0]
    if n < p + 1:
        raise ValueError(f"n={n} samples insufficient for AR({p}) OLS fit")
    flat = x.reshape(n, -1)
    X = torch.cat(
        [torch.stack([flat[k - i - 1] for i in range(p)], dim=-1) for k in range(p, n)]
    )  # (N, p)
    y = torch.cat([flat[k] for k in range(p, n)])
    if include_constant_term:
        X = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
    XtX = X.T @ X + lam * torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    phi = torch.linalg.solve(XtX, X.T @ y)
    resid = y - X @ phi
    phi_pert = resid.std(correction=0)
    phi_main = phi[:p]
    if check_stationarity and not test_ar_stationarity(phi_main.detach().cpu().numpy()):
        raise RuntimeError("nonstationary AR(p) process")
    if d == 1:
        phi_main = _differenced_to_undifferenced(phi_main)
    return torch.cat([phi_main, phi_pert[None]])


def _pixel_solve(A, b):
    """Solve A x = b at every pixel: A (r, r, *spatial), b (r, c, *spatial)
    -> x (r, c, *spatial)."""
    r, c = A.shape[0], b.shape[1]
    spatial = A.shape[2:]
    A_px = torch.movedim(A.reshape(r, r, -1), -1, 0)
    b_px = torch.movedim(b.reshape(r, c, -1), -1, 0)
    return torch.movedim(torch.linalg.solve(A_px, b_px), 0, -1).reshape((r, c) + spatial)


def estimate_ar_params_ols_localized(
    x, p, window_radius, d=0, include_constant_term=False, h=0, lam=0.0,
    window="gaussian", device=None,
):
    """Per-pixel OLS AR(p) fit with moving-window weighting of the normal
    equations, x (n, m, n_cols).  Returns (p+1, m, n_cols) parameter maps,
    the last the innovation standard deviation."""
    x = _t(x, resolve_device(device, x))
    if d == 1:
        x = torch.diff(x, dim=0)
    n = x.shape[0]
    if n < p + 1:
        raise ValueError(f"{n} samples insufficient for AR({p})")
    k1d = _window_kernel(window_radius, window, x.device)

    def smooth(f):
        return _sep_conv2d(f, k1d)

    # A[i, j] = <x_{t-i-1} x_{t-j-1}>_w, b[i] = <x_t x_{t-i-1}>_w over t
    A = torch.zeros((p, p) + x.shape[1:], dtype=x.dtype, device=x.device)
    b = torch.zeros((p,) + x.shape[1:], dtype=x.dtype, device=x.device)
    for t in range(p, n):
        for i in range(p):
            b[i] += smooth(x[t] * x[t - i - 1])
            for j in range(i, p):
                val = smooth(x[t - i - 1] * x[t - j - 1])
                A[i, j] += val
                if j != i:
                    A[j, i] += val
    A = A + lam * torch.eye(p, dtype=x.dtype, device=x.device)[..., None, None]
    phi = _pixel_solve(A, b[:, None])[:, 0]
    resid_pow = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for t in range(p, n):
        pred = sum(phi[i] * x[t - i - 1] for i in range(p))
        resid_pow = resid_pow + smooth((x[t] - pred) ** 2)
    phi_pert = torch.sqrt(resid_pow / max(n - p, 1))
    if d == 1:
        phi = torch.movedim(_differenced_to_undifferenced(torch.movedim(phi, 0, -1)), -1, 0)
    return torch.cat([phi, phi_pert[None]], dim=0)


def estimate_var_params_ols(
    x, p, d=0, check_stationarity=True, include_constant_term=False, h=0, lam=0.0,
    device=None,
):
    """OLS VAR(p) fit from a q-variate series x (n, q, ...).  Returns the
    (q, q) matrices Phi_1..Phi_p and the square root of the innovation
    covariance."""
    x = _t(x, resolve_device(device, x))
    if d == 1:
        x = torch.diff(x, dim=0)
    n, q = x.shape[:2]
    flat = x.reshape(n, q, -1)
    X = torch.cat(
        [torch.cat([flat[t - i - 1] for i in range(p)], dim=0).T for t in range(p, n)]
    )  # (N, q p)
    Y = torch.cat([flat[t].T for t in range(p, n)])  # (N, q)
    XtX = X.T @ X + lam * torch.eye(q * p, dtype=X.dtype, device=X.device)
    B = torch.linalg.solve(XtX, X.T @ Y)  # (q p, q)
    phi = [B[i * q : (i + 1) * q].T for i in range(p)]
    resid = Y - X @ B
    sigma = resid.T @ resid / max(X.shape[0] - 1, 1)
    w, V = torch.linalg.eigh((sigma + sigma.T) / 2)
    phi.append(V @ torch.diag(torch.sqrt(torch.clamp(w, min=0.0))) @ V.T)
    if check_stationarity and not test_var_stationarity(
        [m.detach().cpu().numpy() for m in phi[:p]]
    ):
        raise RuntimeError("nonstationary VAR(p) process")
    return phi


def estimate_var_params_ols_localized(
    x, p, window_radius, d=0, include_constant_term=False, h=0, lam=0.0,
    window="gaussian", device=None,
):
    """Per-pixel OLS VAR(p) fit with moving-window weighting, x (n, q, m,
    n_cols) of length n = p+d+h+1.  Returns [c?, Phi_1..Phi_p, Phi_p+1],
    each Phi (q, q, m, n_cols), the constant c (q, m, n_cols) first if
    asked for, and Phi_p+1 zeros."""
    x = _t(x, resolve_device(device, x))
    n, q = x.shape[:2]
    if n != p + d + h + 1:
        raise ValueError(f"n={n} but n = p+d+h+1 = {p + d + h + 1} required")
    if d == 1:
        x = torch.diff(x, dim=0)
        n -= 1
    spatial = x.shape[2:]
    k1d = _window_kernel(window_radius, window, x.device)

    def smooth(f):
        return _sep_conv2d(f, k1d)

    nc = p * q + (1 if include_constant_term else 0)
    off = 1 if include_constant_term else 0
    # per-pixel normal equations B Z2 = XZ:
    # XZ[a, (k,b)] = sum_l <x[p+l, a] x[p-1-k+l, b]>_w,
    # Z2[(i,a),(k,b)] = sum_l <x[p-1-i+l, a] x[p-1-k+l, b]>_w
    XZ = torch.zeros((q, nc) + spatial, dtype=x.dtype, device=x.device)
    Z2 = torch.zeros((nc, nc) + spatial, dtype=x.dtype, device=x.device)
    for lag in range(h + 1):
        if include_constant_term:
            Z2[0, 0] += smooth(torch.ones(spatial, dtype=x.dtype, device=x.device))
            for i in range(p):
                for a in range(q):
                    s = smooth(x[p - 1 - i + lag, a])
                    Z2[0, off + i * q + a] += s
                    Z2[off + i * q + a, 0] += s
            for a in range(q):
                XZ[a, 0] += smooth(x[p + lag, a])
        for a in range(q):
            for k in range(p):
                for b in range(q):
                    XZ[a, off + k * q + b] += smooth(x[p + lag, a] * x[p - 1 - k + lag, b])
        for i in range(p):
            for a in range(q):
                for k in range(p):
                    for b in range(q):
                        if (k, b) < (i, a):
                            continue  # filled by the symmetric copy below
                        s = smooth(x[p - 1 - i + lag, a] * x[p - 1 - k + lag, b])
                        Z2[off + i * q + a, off + k * q + b] += s
                        if (i, a) != (k, b):
                            Z2[off + k * q + b, off + i * q + a] += s
    Z2 = Z2 + lam * torch.eye(nc, dtype=x.dtype, device=x.device)[..., None, None]
    # B Z2 = XZ  <=>  Z2^T B^T = XZ^T
    B = _pixel_solve(Z2.transpose(0, 1), XZ.transpose(0, 1)).transpose(0, 1)
    out = []
    if include_constant_term:
        out.append(B[:, 0])
    phi = [B[:, off + k * q : off + (k + 1) * q] for k in range(p)]
    if d == 1:
        eye = torch.eye(q, dtype=x.dtype, device=x.device)[..., None, None]
        phi_u = [phi[0] + eye]
        for i in range(1, p):
            phi_u.append(phi[i] - phi[i - 1])
        phi_u.append(-phi[p - 1])
        phi = phi_u
    out.extend(phi)
    out.append(torch.zeros((q, q) + spatial, dtype=x.dtype, device=x.device))
    return out


def estimate_var_params_yw_localized(gamma, d=0, device=None):
    """Per-pixel Yule-Walker VAR fit from p+1 correlation-matrix maps
    Gamma_0..Gamma_p, each (q, q, m, n).  Returns Phi_1..Phi_p and a zero
    Phi_p+1, each (q, q, m, n)."""
    dev = resolve_device(device, *gamma)
    gamma = [_t(g, dev) for g in gamma]
    q = gamma[0].shape[0]
    p = len(gamma) - 1
    spatial = gamma[0].shape[2:]
    G = torch.zeros((p * q, p * q) + spatial, dtype=gamma[0].dtype, device=gamma[0].device)
    for i in range(p):
        for j in range(p):
            blk = gamma[abs(i - j)]
            if i > j:
                blk = blk.transpose(0, 1)
            G[i * q : (i + 1) * q, j * q : (j + 1) * q] = blk
    b = torch.cat([gamma[i].transpose(0, 1) for i in range(1, p + 1)], dim=0)
    x = _pixel_solve(G, b)
    phi = [x[i * q : (i + 1) * q] for i in range(p)]
    phi.append(torch.zeros_like(gamma[0]))
    return phi


def iterate_ar_model(x, phi, eps=None, device=None):
    """One AR(p) step on a window x (..., p, m, n) of the p latest states
    (oldest first) with parameters phi (..., p+1) and an optional
    innovation eps (..., m, n).  Returns the window shifted by one, ending
    in the new state."""
    dev = resolve_device(device, x, phi, eps)
    x, phi = _t(x, dev), _t(phi, dev)
    p = x.shape[-3]
    coeffs = torch.flip(phi[..., :p], dims=(-1,))  # lag i+1 weights x[..., -(i+1)]
    x_new = torch.sum(x * coeffs[..., :, None, None], dim=-3)
    if eps is not None:
        x_new = x_new + phi[..., -1:, None] * _t(eps, dev)
    return torch.cat([x[..., 1:, :, :], x_new[..., None, :, :]], dim=-3)


def iterate_var_model(x, phi, eps=None, device=None):
    """One VAR(p) step: x (p, q, ...) window, phi a list of p+1 (q, q)
    matrices (the last the innovation factor)."""
    dev = resolve_device(device, x, *phi, eps)
    x = _t(x, dev)
    p = len(phi) - 1
    x_new = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for lag in range(p):
        x_new = x_new + torch.einsum("ij,j...->i...", _t(phi[lag], dev), x[-(lag + 1)])
    if eps is not None:
        x_new = x_new + torch.einsum("ij,j...->i...", _t(phi[-1], dev) @ _t(phi[-1], dev),
                                     _t(eps, dev))
    return torch.cat([x[1:], x_new[None]], dim=0)


def estimate_var_params_yw(gamma, d=0, check_stationarity=True, device=None):
    """Yule-Walker VAR(p) fit from the lag cross-correlation matrices
    Gamma_0..Gamma_p (q, q).  Returns Phi_1..Phi_p and a zero innovation
    matrix."""
    dev = resolve_device(device, *gamma)
    gamma = [_t(g, dev) for g in gamma]
    q = gamma[0].shape[0]
    p = len(gamma) - 1
    G = torch.cat([
        torch.cat([gamma[abs(i - j)].T if i > j else gamma[abs(i - j)] for j in range(p)],
                  dim=1)
        for i in range(p)
    ], dim=0)
    b = torch.cat([gamma[i].T for i in range(1, p + 1)], dim=0)
    x = torch.linalg.solve(G, b)
    phi = [x[i * q : (i + 1) * q, :] for i in range(p)]
    if check_stationarity and not test_var_stationarity(
        [m.detach().cpu().numpy() for m in phi]
    ):
        raise RuntimeError("nonstationary VAR(p) process")
    phi.append(torch.zeros_like(gamma[0]))
    return phi


def ar_acf(gamma, n=None):
    """The lag correlations extended to the first ``n`` lags of the fitted
    AR(p)'s theoretical autocorrelation function (a list of floats)."""
    if isinstance(gamma, torch.Tensor):
        gamma = gamma.detach().cpu().numpy()
    gamma = list(np.asarray(g) for g in np.atleast_1d(np.asarray(gamma)))
    ar_order = len(gamma)
    if n is None or n == ar_order:
        return gamma
    if n < ar_order:
        raise ValueError(f"n={n} must be larger than the AR order {ar_order}")
    phi = estimate_ar_params_yw(np.asarray(gamma, np.float32), device="cpu").numpy()[:-1]
    acf = [float(g) for g in gamma]
    for t in range(n - ar_order):
        gammas = np.array(acf[t : t + ar_order])[::-1]
        acf.append(float(np.sum(gammas * phi)))
    return acf


def test_ar_stationarity(phi):
    """Whether the AR(p) characteristic roots lie inside the unit circle
    (numpy, on the host)."""
    phi = np.asarray(phi)
    p = len(phi)
    if p == 0:
        return True
    companion = np.zeros((p, p))
    companion[0, :] = phi
    if p > 1:
        companion[1:, :-1] = np.eye(p - 1)
    return bool(np.all(np.abs(np.linalg.eigvals(companion)) < 1.0))


def test_var_stationarity(phi):
    """VAR stationarity: the block companion's spectral radius below 1."""
    phi = [np.asarray(m) for m in phi]
    q = phi[0].shape[0]
    p = len(phi)
    comp = np.zeros((p * q, p * q))
    comp[:q, :] = np.concatenate(phi, axis=1)
    if p > 1:
        comp[q:, :-q] = np.eye((p - 1) * q)
    return bool(np.all(np.abs(np.linalg.eigvals(comp)) < 1.0))
