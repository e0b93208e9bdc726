"""Variational Echo Tracking (counterpart of ``pysteps_tpu/motion/vet.py``;
Laroche & Zawadzki 1995, Germann & Zawadzki 2002).

The cost of a sector displacement is the masked squared difference
between the warped template and the target plus a second-difference
smoothness penalty; the sector displacements reach the pixels through
two interpolation matrices.  Autograd differentiates it, and Adam under
optax's cosine-decayed learning rate minimizes it, one Python step at a
time, over the same coarse-to-fine sector scales as the JAX module.  The
global shift that seeds the coarsest scale (numpy FFT) and the zooms
between scales (``scipy.ndimage.zoom``) run on the host, as in the JAX
module.

The warp follows the JAX module's branch: ``max_disp="auto"`` is
``"shift"`` on the card, the shift-decomposition warp through kernel K1,
recentred on the integer global shift, whose gradient is
``ops/pallas_warp.py::AxisResample``; on the CPU it is the exact bilinear
gather, differentiated by autograd.

With ``mesh`` the masked squared difference of each consecutive pair is
summed over the rows of the mesh's "y" dimension
(:func:`_make_cost_sharded`): every rank warps the replicated template by
the exact bilinear gather at its own rows, and the value and the
gradient are all-reduced, so every rank holds the same sector
displacements after every Adam step.  The smoothness penalty stays
replicated, and the shift pre-centring is skipped, as in the JAX module.
"""

import math

import numpy as np
import torch
from scipy.ndimage import zoom
from torch.distributed.device_mesh import DeviceMesh

from pysteps_tpu_torch._device import device_of
from pysteps_tpu_torch.ops.warp import _grid, bilinear_warp, warp_shifted, warp_shifted_multi
from pysteps_tpu_torch.parallel.mesh import all_reduce, axis_index, axis_size


def round_int(scalar):
    """Nearest integer as int."""
    return int(np.round(scalar))


def ceil_int(scalar):
    """Ceiling as int."""
    return int(np.ceil(scalar))


def morph(image, displacement, gradient=False, device=None):
    """Backward-warp ``image`` by ``displacement`` (2, m, n), which refers
    to the destination: out[x] = image[x - d[x]], d[0] along axis 0 and
    d[1] along axis 1.  Returns numpy (morphed, mask): mask (int8) is 2
    where the source fell outside the domain (clamped to the edge), 1
    where a masked input was sampled; with ``gradient``, also the (2, m, n)
    derivative of the morphed image by each displacement component."""
    if isinstance(image, np.ma.MaskedArray):
        in_mask = np.ma.getmaskarray(image).astype(np.float64)
        img = np.asarray(np.ma.filled(image, 0.0), np.float64)
    else:
        img = np.asarray(image, np.float64)
        in_mask = (~np.isfinite(img)).astype(np.float64)
        img = np.where(np.isfinite(img), img, 0.0)
    disp = np.asarray(displacement, np.float64)
    m, n = img.shape
    yy, xx = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    cy = yy - disp[0]
    cx = xx - disp[1]
    outside = (cy < 0) | (cy > m - 1) | (cx < 0) | (cx > n - 1)
    dev = device_of(None, device)
    cyt = torch.as_tensor(cy, dtype=torch.float32, device=dev)
    cxt = torch.as_tensor(cx, dtype=torch.float32, device=dev)

    def warp_host(f):
        f = torch.as_tensor(f, dtype=torch.float32, device=dev)
        return bilinear_warp(f, cyt, cxt, mode="nearest").cpu().numpy().astype(np.float64)

    warped = warp_host(img)
    mask = np.where(outside, 2, np.where(warp_host(in_mask) > 0, 1, 0)).astype(np.int8)
    if not gradient:
        return warped, mask
    # d out / d d_k = -dI/dx_k at the source coordinate
    gy, gx = np.gradient(img)
    return warped, mask, np.stack([-warp_host(g) for g in (gy, gx)])


def vet_cost_function(sector_displacement_1d, input_images, blocks_shape, mask, smooth_gain,
                      debug=False, gradient=False, device=None):
    """The VET cost (masked SSD and smoothness) of the flat sector
    displacements, or its gradient with ``gradient=True`` (a float64 numpy
    vector): one cost-and-gradient evaluation."""
    input_images = np.asarray(input_images, np.float64)
    template, target = input_images[0], input_images[-1]
    m, n = template.shape
    si, sj = int(blocks_shape[0]), int(blocks_shape[1])
    dev = device_of(None, device)
    fn = _make_cost(
        torch.as_tensor(template, dtype=torch.float32, device=dev),
        torch.as_tensor(target, dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(mask, bool), device=dev),
        float(smooth_gain), (si, sj), _interp_matrices(m, n, si, sj, dev),
    )
    value, grad = fn(torch.as_tensor(np.asarray(sector_displacement_1d), dtype=torch.float32,
                                     device=dev))
    if debug:
        print("cost", float(value))
    if gradient:
        return grad.cpu().numpy().astype(np.float64).ravel()
    return float(value)


def vet_cost_function_gradient(*args, **kwargs):
    """The gradient of :func:`vet_cost_function`."""
    kwargs["gradient"] = True
    return vet_cost_function(*args, **kwargs)


def get_padding(dimension_size, sectors):
    """The (before, after) padding that makes the dimension divide into
    ``sectors`` evenly."""
    rem = dimension_size % sectors
    if rem != 0:
        pad = sectors - rem
        before = pad // 2
        return before, before if pad % 2 == 0 else before + 1
    return 0, 0


def _sector_centers(size, n_sectors):
    coords = np.arange(size, dtype=np.float64)
    return coords.reshape(n_sectors, size // n_sectors).mean(axis=1)


def _interp_matrix(size, n_sectors):
    """The (size, n_sectors) linear sector-to-pixel interpolation matrix,
    extrapolating linearly beyond the outer sector centres."""
    W = np.zeros((size, n_sectors), np.float32)
    if n_sectors == 1:
        W[:, 0] = 1.0
        return W
    centers = _sector_centers(size, n_sectors)
    coords = np.arange(size, dtype=np.float64)
    idx = np.clip(np.searchsorted(centers, coords, side="right") - 1, 0, n_sectors - 2)
    t = (coords - centers[idx]) / (centers[idx + 1] - centers[idx])
    W[np.arange(size), idx] = 1.0 - t
    W[np.arange(size), idx + 1] = t
    return W


def _interp_matrices(m, n, si, sj, device):
    return (torch.as_tensor(_interp_matrix(m, si), device=device),
            torch.as_tensor(_interp_matrix(n, sj), device=device))


def _sector_to_pixels(sector_displacement, sectors, interp_mats):
    """The sector displacements (2, si, sj) at every pixel:
    R @ d[c] @ C^T."""
    R, C = interp_mats
    return torch.einsum("mi,cij,nj->cmn", R, sector_displacement, C)


def _smoothness_penalty(d):
    """The second-difference penalty over the sector grid."""
    total = 0.0
    for comp in (d[0], d[1]):
        if comp.shape[0] > 2:
            total = total + ((comp[2:, :] - 2 * comp[1:-1, :] + comp[:-2, :]) ** 2).sum()
        if comp.shape[1] > 2:
            total = total + ((comp[:, 2:] - 2 * comp[:, 1:-1] + comp[:, :-2]) ** 2).sum()
        if comp.shape[0] > 1 and comp.shape[1] > 1:
            dxy = comp[1:, 1:] - comp[1:, :-1] - comp[:-1, 1:] + comp[:-1, :-1]
            total = total + 2.0 * (dxy**2).sum()
    return total


def _cost_function(template, target, mask, smooth_gain, sectors, interp_arrays,
                   max_disp=None, center_shift=(0, 0)):
    """The scalar cost of one sector scale as a function of the flat
    sector displacements x: the masked SSD of the warped template and the
    target plus ``smooth_gain`` x the smoothness penalty x the sector area
    x the pairs.

    ``template`` (m, n) or (P, m, n) pairs that share one flow.  The
    displacement refers to the destination, ``displacement[0]`` moving
    rows.  ``max_disp`` (int): the shift-decomposition warp with that
    bound; ``center_shift``: the integer global displacement the caller
    pre-shifted ``template`` by, so that the warp covers the residual only.
    """
    m, n = template.shape[-2:]
    yy, xx = _grid(m, n, template)
    gi, gj = float(center_shift[0]), float(center_shift[1])
    multi = template.ndim == 3
    sector_area = (m // sectors[0]) * (n // sectors[1])
    n_pairs = template.shape[0] if multi else 1

    def cost(x):
        d = x.reshape((2,) + tuple(sectors))
        disp = _sector_to_pixels(d, tuple(sectors), interp_arrays)
        if max_disp is not None:
            shift = torch.stack([-(disp[1] - gj), -(disp[0] - gi)])
            if multi:
                warped = warp_shifted_multi(template, shift, int(max_disp), mode="nearest")
            else:
                warped = warp_shifted(template, shift, int(max_disp), mode="nearest")
        else:
            warped = bilinear_warp(template, yy - disp[0], xx - disp[1], mode="nearest")
        resid = torch.where(mask, 0.0, (warped - target) ** 2)
        return resid.sum() + smooth_gain * _smoothness_penalty(d) * sector_area * n_pairs

    return cost


def _make_cost(*args, **kwargs):
    """The cost-and-gradient function of one sector scale (the arguments of
    :func:`_cost_function`): x -> (cost, d cost / d x), both detached."""
    return _value_and_grad(_cost_function(*args, **kwargs))


def _value_and_grad(cost):
    """x -> (cost(x), d cost / d x), both detached."""

    def value_and_grad(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            val = cost(x)
            (grad,) = torch.autograd.grad(val, x)
        return val.detach(), grad

    return value_and_grad


class _SumOverRanks(torch.autograd.Function):
    """Identity on a replicated input whose gradient is summed over the
    mesh dimension ``name``: a rank's cost term depends on its own rows
    only, so the replicated input's gradient is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.name), None, None


def _make_cost_sharded(template, target, mask, smooth_gain, sectors, interp_arrays, mesh):
    """:func:`_make_cost` with the masked squared difference computed on the
    rank's rows of the mesh's "y" dimension and summed over it; the
    template (warped by the exact bilinear gather, which reaches any row),
    the sector displacement and the smoothness penalty stay replicated.
    Falls back to :func:`_make_cost` where "y" does not divide the rows."""
    m, n = template.shape
    n_shards = axis_size(mesh, "y")
    if m % n_shards:
        return _make_cost(template, target, mask, smooth_gain, sectors, interp_arrays)
    m_loc = m // n_shards
    row0 = axis_index(mesh, "y") * m_loc
    yy, xx = _grid(m, n, template)
    yy = yy[row0 : row0 + m_loc]
    target_l = target[row0 : row0 + m_loc]
    mask_l = mask[row0 : row0 + m_loc]
    sector_area = (m // sectors[0]) * (n // sectors[1])

    def value_and_grad(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            d = x.reshape((2,) + tuple(sectors))
            disp = _sector_to_pixels(_SumOverRanks.apply(d, mesh, "y"), tuple(sectors),
                                     interp_arrays)[:, row0 : row0 + m_loc]
            warped = bilinear_warp(template, yy - disp[0], xx - disp[1], mode="nearest")
            ssd = torch.where(mask_l, 0.0, (warped - target_l) ** 2).sum()
            penalty = smooth_gain * _smoothness_penalty(d) * sector_area
            (grad,) = torch.autograd.grad(ssd + penalty, x)
        return all_reduce(ssd.detach(), mesh, "y") + penalty.detach(), grad

    return value_and_grad


def _pad_to_sectors(imgs, mask, si, sj):
    """``imgs`` (T, m, n) and ``mask`` edge-padded so that ``si`` x ``sj``
    sectors divide them."""
    pad_i = get_padding(imgs.shape[1], si)
    pad_j = get_padding(imgs.shape[2], sj)
    if (pad_i, pad_j) != ((0, 0), (0, 0)):
        imgs = np.pad(imgs, ((0, 0), pad_i, pad_j), "edge")
        mask = np.pad(mask, (pad_i, pad_j), "edge")
    return imgs, mask


def _pair_costs_sharded(imgs, mask, sectors, smooth_gain, device, mesh):
    """One :func:`_make_cost_sharded` for each consecutive pair of ``imgs``
    (T, m, n), padded so that the ``sectors`` divide them."""
    si, sj = int(sectors[0]), int(sectors[1])
    imgs, mask = _pad_to_sectors(imgs, mask, si, sj)
    m, n = imgs.shape[1:]
    interp = _interp_matrices(m, n, si, sj, device)
    mask_t = torch.as_tensor(mask, device=device)
    return [_make_cost_sharded(torch.as_tensor(imgs[a], dtype=torch.float32, device=device),
                               torch.as_tensor(imgs[a + 1], dtype=torch.float32, device=device),
                               mask_t, smooth_gain, (si, sj), interp, mesh)
            for a in range(imgs.shape[0] - 1)]


def _scale_cost(imgs, mask, guess, sectors, max_disp, gshift, smooth_gain, device):
    """The differentiable cost of one sector scale, every consecutive pair
    of ``imgs`` (T, m, n) sharing the flow, with the images and ``mask``
    edge-padded so that the ``sectors`` divide them.  With
    ``max_disp="shift"`` the templates are pre-shifted by the integer
    global shift ``gshift`` and the warp's bound covers only how far
    ``guess`` (2, si, sj) strays from it, plus the optimizer's headroom.
    Returns (cost, the warp's bound)."""
    si, sj = int(sectors[0]), int(sectors[1])
    imgs, mask = _pad_to_sectors(imgs, mask, si, sj)
    m, n = imgs.shape[1:]
    templates = imgs[:-1]
    center = (0, 0)
    bound = max_disp
    if max_disp == "shift":
        resid = np.max(np.abs(guess - np.asarray(gshift).reshape(2, 1, 1)))
        bound = int(np.clip(np.ceil(resid) + 6, 8, 24))
        center = tuple(gshift)
        ii = np.clip(np.arange(m) - center[0], 0, m - 1)
        jj = np.clip(np.arange(n) - center[1], 0, n - 1)
        templates = templates[:, ii][:, :, jj]
    cost = _cost_function(
        torch.as_tensor(templates, dtype=torch.float32, device=device),
        torch.as_tensor(imgs[1:], dtype=torch.float32, device=device),
        torch.as_tensor(mask, device=device), smooth_gain, (si, sj),
        _interp_matrices(m, n, si, sj, device),
        max_disp=None if bound is None else int(bound), center_shift=center)
    return cost, bound


def _global_shift(template, target):
    """The global translation (di, dj), target(x) ~ template(x - d), from
    the FFT cross-correlation's peak: it seeds the coarsest scale."""
    t = template - np.mean(template)
    g = target - np.mean(target)
    xc = np.fft.irfft2(np.fft.rfft2(g) * np.conj(np.fft.rfft2(t)), s=t.shape)
    idx = np.unravel_index(np.argmax(xc), xc.shape)
    di = idx[0] if idx[0] <= t.shape[0] // 2 else idx[0] - t.shape[0]
    dj = idx[1] if idx[1] <= t.shape[1] // 2 else idx[1] - t.shape[1]
    return float(di), float(dj)


def _cosine_lr(lr, step, n_steps, alpha=0.02):
    """optax's ``cosine_decay_schedule(lr, n_steps, alpha)`` at ``step``."""
    t = min(step, n_steps) / n_steps
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha)


def _minimize_adam(cost_fns, x0, n_steps=300, lr=0.3):
    """Minimize the sum of the costs with Adam under a cosine-decayed
    learning rate, ``n_steps`` steps; returns (x, the cost at the last
    step's start)."""
    x = x0.detach().clone()
    opt = torch.optim.Adam([x], lr=lr)
    val = None
    for step in range(n_steps):
        vals = [c(x) for c in cost_fns]
        val = sum(v for v, _ in vals)
        x.grad = sum(g for _, g in vals)
        opt.param_groups[0]["lr"] = _cosine_lr(lr, step, n_steps)
        opt.step()
    return x.detach(), float(val)


def vet(input_images, sectors=((32, 16, 4, 2), (32, 16, 4, 2)), smooth_gain=1e6,
        first_guess=None, intermediate_steps=False, verbose=True, indexing="yx", padding=0,
        options=None, mesh=None, max_disp="auto", device=None, **kwargs):
    """VET dense displacement (2, m, n), in pixels a time step (x first
    with ``indexing="yx"``), of a (2 or 3, m, n) sequence, as a float32
    tensor on the run's device; ``intermediate_steps`` adds each scale's
    sector displacements (numpy).  ``mesh`` (a ``parallel.make_mesh``
    mesh of the run's device type; every rank calls with the same images)
    sums each pair's cost over the rows of its "y" dimension
    (:func:`_make_cost_sharded`)."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a DeviceMesh (parallel.make_mesh)")
    dev = device_of(input_images, device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run VET on {dev}")
    if isinstance(input_images, torch.Tensor):
        input_images = input_images.detach().cpu().numpy()
    input_images = np.asarray(input_images, dtype=np.float64)
    if input_images.ndim != 3 or input_images.shape[0] not in (2, 3):
        raise ValueError("input_images must have shape (2 or 3, m, n)")
    options = dict(options or {})
    maxiter = options.pop("maxiter", 100)
    options.pop("gtol", 0.1)

    mask = ~np.isfinite(input_images)
    fill = np.nanmin(input_images)
    imgs = np.where(mask, fill, input_images)
    mask_any = np.any(mask, axis=0)
    if padding > 0:
        imgs = np.pad(imgs, ((0, 0), (padding, padding), (padding, padding)), "edge")
        mask_any = np.pad(mask_any, ((padding, padding), (padding, padding)), "edge")

    if isinstance(sectors, (tuple, list)) and np.ndim(sectors[0]) > 0:
        sectors_i = np.sort(np.asarray(sectors[0]))  # coarse -> fine
        sectors_j = np.sort(np.asarray(sectors[1]))
    else:
        sectors_i = np.sort(np.asarray(sectors))
        sectors_j = sectors_i
    pairs = list(zip(sectors_i, sectors_j))
    if first_guess is None:
        guess = np.zeros((2, int(pairs[0][0]), int(pairs[0][1])))
        di, dj = _global_shift(imgs[0], imgs[1])
        guess[0] += di
        guess[1] += dj
    else:
        guess = np.asarray(first_guess, dtype=np.float64)
    if max_disp == "auto":
        # the card takes the shift warp recentred on the integer global
        # shift (the template pre-shifted on the host), so that the bound
        # covers only the residual deformation; the CPU the exact gather
        max_disp = "shift" if dev.type == "cuda" else None
    gshift = ((round_int(guess[0].mean()), round_int(guess[1].mean()))
              if max_disp == "shift" else (0, 0))
    scaling_guesses = []
    prev = pairs[0]

    for n_scale, (si, sj) in enumerate(pairs):
        if n_scale > 0:
            guess = zoom(guess, (1, si / prev[0], sj / prev[1]), order=1, mode="nearest")
        if mesh is not None:
            pairs_cost = _pair_costs_sharded(imgs, mask_any, (si, sj), smooth_gain, dev, mesh)
        else:
            cost, _ = _scale_cost(imgs, mask_any, guess, (si, sj), max_disp, gshift,
                                  smooth_gain, dev)
            pairs_cost = [_value_and_grad(cost)]
        # the coarse scales (at most 4 sectors a side) take fewer steps
        n_scale_steps = max(maxiter, 150) if max(int(si), int(sj)) > 4 else max(maxiter, 80)
        x, final_cost = _minimize_adam(
            pairs_cost, torch.as_tensor(guess.ravel(), dtype=torch.float32, device=dev),
            n_steps=n_scale_steps)
        guess = x.cpu().numpy().astype(np.float64).reshape(guess.shape)
        if verbose:
            print(f"VET scale {si}x{sj}: cost={final_cost:.4g}")
        scaling_guesses.append(guess[::-1] if indexing == "yx" else guess)
        prev = (si, sj)

    # the last scale's sector displacements at every pixel
    m, n = imgs.shape[1:]
    pad_i = get_padding(m, prev[0])
    pad_j = get_padding(n, prev[1])
    mi = m + pad_i[0] + pad_i[1]
    nj = n + pad_j[0] + pad_j[1]
    dense = zoom(guess, (1, mi / prev[0], nj / prev[1]), order=1, mode="nearest")
    dense = dense[:, pad_i[0]: mi - pad_i[1], pad_j[0]: nj - pad_j[1]]
    if indexing == "yx":
        dense = dense[::-1]
    if padding > 0:
        dense = dense[:, padding:-padding, padding:-padding]
    dense = torch.as_tensor(np.ascontiguousarray(dense), dtype=torch.float32, device=dev)
    if intermediate_steps:
        return dense, scaling_guesses
    return dense
