"""Constant advection field (counterpart of
``pysteps_tpu/motion/constant.py``): a grid search over shifts of 2
pixels that maximizes the correlation of the shifted previous frame with
the last one, then 8 shrinking cross-pattern refinements, all through the
exact bilinear warp."""

import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.ops.warp import warp

_CHUNK = 64  # candidate shifts warped in one batch


def constant(R, device=None, **kwargs):
    """Constant advection field (2, m, n) from the last two frames of R;
    ``max_shift`` (default 20) bounds the grid search."""
    R = as_device_tensor(R, device, torch.float32)
    prev, curr = R[-2], R[-1]
    m, n = curr.shape
    finite = torch.isfinite(prev) & torch.isfinite(curr)
    prev_f = torch.where(finite, prev, 0.0)
    curr_f = torch.where(finite, curr, 0.0)
    max_shift = kwargs.get("max_shift", 20)

    def objective(cands):
        # backward-warp prev by -v and correlate with curr, per candidate
        scores = []
        for c in torch.split(cands, _CHUNK):
            disp = (-c)[:, :, None, None].expand(c.shape[0], 2, m, n)
            shifted = warp(prev_f, disp, order=1, cval=0.0)
            num = (shifted * curr_f).sum(dim=(1, 2))
            den = torch.sqrt((shifted**2).sum(dim=(1, 2)) * (curr_f**2).sum())
            scores.append(-num / torch.clamp(den, min=1e-12))
        return torch.cat(scores)

    shifts = torch.arange(-max_shift, max_shift + 1, 2.0, device=R.device)
    vy, vx = torch.meshgrid(shifts, shifts, indexing="ij")
    cands = torch.stack([vx.reshape(-1), vy.reshape(-1)], dim=1)
    best = cands[torch.argmin(objective(cands))]

    step = 1.0
    for _ in range(8):
        offsets = torch.tensor([[0, 0], [step, 0], [-step, 0], [0, step], [0, -step]],
                               dtype=torch.float32, device=R.device)
        pts = best[None, :] + offsets
        best = pts[torch.argmin(objective(pts))]
        step *= 0.6
    return best[:, None, None].expand(2, m, n).clone()
