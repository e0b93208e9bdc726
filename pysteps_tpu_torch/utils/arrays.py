"""Array helpers (counterpart of ``pysteps_tpu/utils/arrays.py``)."""

import numpy as np
import torch


def compute_centred_coord_array(M, N):
    """Open-grid (yc, xc) coordinates of an (M, N) grid with the origin at
    the centre, broadcastable to (M, N)."""
    if M % 2 == 1:
        s1 = np.s_[-int(M / 2) : int(M / 2) + 1]
    else:
        s1 = np.s_[-int(M / 2) : int(M / 2)]
    if N % 2 == 1:
        s2 = np.s_[-int(N / 2) : int(N / 2) + 1]
    else:
        s2 = np.s_[-int(N / 2) : int(N / 2)]
    yc, xc = np.ogrid[s1, s2]
    return yc, xc


def _nanmin(x, dim=None):
    """The smallest non-NaN value of ``x`` (along ``dim``), as a tensor."""
    filled = torch.where(torch.isnan(x), float("inf"), x)
    return filled.amin() if dim is None else filled.amin(dim=dim)
