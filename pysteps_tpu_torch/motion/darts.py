"""DARTS spectral optical flow (counterpart of
``pysteps_tpu/motion/darts.py``; Ruzanski, Chandrasekar & Wang 2011).

The DARTS system is gathered from the 3-D DFT of the sequence in one
modular index, and its least-squares solve is the pseudo-inverse of the
complex64 normal matrix by ``torch.linalg.svd``.  Singular vectors may
differ from another library's by a phase; the pseudo-inverse does not.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor


def _darts_core(input_images, N_x, N_y, N_t, M_x, M_y, output_type):
    dev = input_images.device
    F = torch.fft.fftn(input_images.permute(1, 2, 0))  # (m, n, T), time last
    T_y, T_x, T_t = F.shape

    m = (2 * N_x + 1) * (2 * N_y + 1) * (2 * N_t + 1)
    n = (2 * M_x + 1) * (2 * M_y + 1)
    k_t, k_y, k_x = np.unravel_index(np.arange(m), (2 * N_t + 1, 2 * N_y + 1, 2 * N_x + 1))
    k_x = torch.as_tensor(k_x - N_x, device=dev)
    k_y = torch.as_tensor(k_y - N_y, device=dev)
    k_t = torch.as_tensor(k_t - N_t, device=dev)
    kp_y, kp_x = np.unravel_index(np.arange(n), (2 * M_y + 1, 2 * M_x + 1))
    kp_x = torch.as_tensor(kp_x - M_x, device=dev)
    kp_y = torch.as_tensor(kp_y - M_y, device=dev)

    # the y-vector: the input DFT at the modular wavenumbers
    y = k_t * F[k_y % T_y, k_x % T_x, k_t % T_t]
    # the H-matrix: (m, n) samples at the shifted wavenumbers
    i_ = k_y[:, None] - kp_y[None, :]
    j_ = k_x[:, None] - kp_x[None, :]
    R_ = F[i_ % T_y, j_ % T_x, (k_t % T_t)[:, None]]
    c1 = -1.0 * T_t / (T_x * T_y)
    A = (c1 / T_y) * i_ * R_
    B = (c1 / T_x) * j_ * R_

    # least squares through the SVD pseudo-inverse of the normal equations
    M = torch.cat([A, B], dim=1)
    M_ct = M.conj().T
    MM = M_ct @ M
    U_s, s, Vh = torch.linalg.svd(MM, full_matrices=False)
    s_inv = torch.where(s > 0.01 * s[0], 1.0 / torch.clamp(s, min=1e-30), 0.0)
    MM_inv = Vh.conj().T @ torch.diag(s_inv.to(MM.dtype)) @ U_s.conj().T
    x = MM_inv @ (M_ct @ y)

    h, w = 2 * M_y + 1, 2 * M_x + 1
    V_spec = x[: h * w].reshape(h, w)
    U_spec = x[h * w:].reshape(h, w)
    if output_type == "spectral":
        return torch.stack([U_spec, V_spec])

    ky, kx = np.meshgrid(np.arange(-M_y, M_y + 1), np.arange(-M_x, M_x + 1), indexing="ij")
    index = (torch.as_tensor(ky % T_y, device=dev), torch.as_tensor(kx % T_x, device=dev))
    full_U = torch.zeros((T_y, T_x), dtype=torch.complex64, device=dev)
    full_V = torch.zeros_like(full_U)
    full_U.index_put_(index, U_spec.to(torch.complex64))
    full_V.index_put_(index, V_spec.to(torch.complex64))
    return torch.stack([torch.fft.ifft2(full_U).real, torch.fft.ifft2(full_V).real])


def DARTS(input_images, device=None, **kwargs):
    """DARTS advection field (2, m, n), in pixels a time step, from a
    (T, m, n) sequence; ``output_type="spectral"`` gives the (2, 2 M_y + 1,
    2 M_x + 1) spectral coefficients instead."""
    N_x = kwargs.get("N_x", 50)
    N_y = kwargs.get("N_y", 50)
    N_t = kwargs.get("N_t", 4)
    M_x = kwargs.get("M_x", 2)
    M_y = kwargs.get("M_y", 2)
    output_type = kwargs.get("output_type", "spatial")
    verbose = kwargs.get("verbose", True)

    input_images = as_device_tensor(input_images, device, torch.float32)
    if N_t >= input_images.shape[0] - 1:
        raise ValueError(f"N_t={N_t} >= T-1={input_images.shape[0] - 1}")
    if output_type not in ("spatial", "spectral"):
        raise ValueError(f"invalid output_type {output_type}")
    # the spectral truncation clamped to the domain
    T, m, n = input_images.shape
    N_y = min(N_y, (m - 1) // 2)
    N_x = min(N_x, (n - 1) // 2)
    N_t = min(N_t, T - 2)
    if verbose:
        print("Computing the motion field with the DARTS method.")
    return _darts_core(input_images, N_x, N_y, N_t, M_x, M_y, output_type)
