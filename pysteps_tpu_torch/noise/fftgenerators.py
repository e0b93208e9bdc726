"""Stochastic noise by Fourier filtering (counterpart of
``pysteps_tpu/noise/fftgenerators.py``).

- Filters are built once, on the device of their input (the card unless
  the caller passes CPU tensors or ``device="cpu"``): the nonparametric
  |FFT| filters, the parametric two-slope power law (whose scalar fit alone
  runs on the host, with SciPy's ``curve_fit``, as in the JAX package), and
  the SSFT and nested stacks of local filters, whose per-window FFTs run
  as one batch.
- Generation draws from an explicit ``torch.Generator`` with a leading
  batch (member) axis: white noise -> FFT -> filter -> inverse FFT ->
  standardization.  The SSFT generator filters each field with every
  window's filter in one batched inverse FFT and composes the windows with
  a mask stack, in member chunks sized from the stack.

The draws cannot reproduce the JAX package's threefry bits, so tests that
compare values hand the JAX draws over by replacing the draw functions of
this module (``_spectral_white``, ``_spectral_phase_white``,
``_white_normal``).

Filter dicts carry "field" (filter magnitudes), "input_shape" and
"use_full_fft"; the parametric one also "model" and "pars", the SSFT and
nested ones "win_fun" and "overlap_gen".
"""

import functools
import math

import numpy as np
import torch

from pysteps_tpu_torch._device import device_of
from pysteps_tpu_torch.utils import spectral as spectral_utils
from pysteps_tpu_torch.utils import tapering as tapering_utils
from pysteps_tpu_torch.utils.arrays import compute_centred_coord_array

# the SSFT generator's member chunk keeps its (chunk, wy, wx, m, n)
# complex64 intermediate within this many bytes
_SSFT_CHUNK_BYTES = 1 << 31


def _prep_field(field, rm_rdisc):
    """A float64 copy of a field stack (..., p, m, n) or one field (m, n)
    as (..., p, m, n): with ``rm_rdisc`` each stack's wet pixels shifted
    down so that its smallest wet value meets its dry value, then each
    field's minimum subtracted."""
    field = torch.as_tensor(field).to(torch.float64)
    if field.ndim == 2:
        field = field[None]
    if rm_rdisc:
        dims = (-3, -2, -1)
        fmin = field.amin(dim=dims, keepdim=True)
        wet = field > fmin
        wmin = torch.where(wet, field, math.inf).amin(dim=dims, keepdim=True)
        field = torch.where(wet, field - (wmin - fmin), field)
    return field - field.amin(dim=(-2, -1), keepdim=True)


def _taper(m, n, win_fun, device, dtype=torch.float64):
    w = (tapering_utils.compute_window_function(m, n, win_fun) if win_fun is not None
         else np.ones((m, n)))
    return torch.as_tensor(w, device=device).to(dtype)


def _standardize(x):
    """(x - mean) / std over the grid axes (population std), where the std
    is positive."""
    mu = x.mean(dim=(-2, -1), keepdim=True)
    sd = x.std(dim=(-2, -1), keepdim=True, correction=0)
    return torch.where(sd > 0, (x - mu) / sd, x)


def _abs_spectrum(fields, full, norm):
    """|mean FFT| over the field axis (-3) of float32 ``fields``: fft2
    planes with ``full``, else rfft2 half-planes; with ``norm`` the real
    and imaginary parts standardized over the plane first."""
    F = (torch.fft.fft2(fields) if full else torch.fft.rfft2(fields)).mean(dim=-3)
    if norm:
        F = torch.complex(_standardize(F.real), _standardize(F.imag))
    return torch.abs(F)


def initialize_nonparam_2d_fft_filter(field, device=None, **kwargs):
    """|FFT| of the input field(s) as the noise filter (the STEPS default).

    kwargs: ``win_fun`` ("tukey"), ``donorm`` (False), ``rm_rdisc`` (True),
    ``use_full_fft`` (False: an (m, n//2+1) half-plane filter)."""
    win_fun = kwargs.get("win_fun", "tukey")
    donorm = kwargs.get("donorm", False)
    rm_rdisc = kwargs.get("rm_rdisc", True)
    use_full_fft = kwargs.get("use_full_fft", False)
    dev = device_of(field, device)
    field = _prep_field(torch.as_tensor(field, device=dev), rm_rdisc)
    m, n = field.shape[-2:]
    tapered = (field * _taper(m, n, win_fun, dev)).to(torch.float32)
    return {
        "field": _abs_spectrum(tapered, use_full_fft, donorm),
        "input_shape": (m, n),
        "use_full_fft": use_full_fft,
    }


def _piecewise_linear(x, x0, y0, beta1, beta2):
    return np.where(x < x0, beta1 * x + y0 - beta1 * x0, beta2 * x + y0 - beta2 * x0)


def _param_psd(field, taper, rm_rdisc=False):
    """Radially averaged PSD of the tapered mean spectrum of a field stack
    (p, m, n) or a field (m, n), in float32 on the field's device."""
    field = field.to(torch.float32)
    if field.ndim == 2:
        field = field[None]
    if rm_rdisc:
        fmin = field.amin()
        wet = field > fmin
        wmin = torch.where(wet, field, math.inf).amin()
        field = torch.where(wet, field - (wmin - fmin), field)
    field = field - field.amin(dim=(1, 2), keepdim=True)
    F = torch.fft.fftshift(torch.fft.fft2(field * taper), dim=(-2, -1)).mean(dim=0)
    psd_2d = torch.abs(F) ** 2 / (field.shape[-2] * field.shape[-1])
    return spectral_utils.rapsd(psd_2d, fft=False)


@functools.lru_cache(maxsize=8)
def _param_log_radius(M, N):
    yc, xc = compute_centred_coord_array(M, N)
    R = np.fft.fftshift(np.sqrt(xc * xc + yc * yc))
    with np.errstate(divide="ignore"):
        return np.log(R).astype(np.float32)


def _param_filter(p4, shape, device):
    """exp(piecewise-linear(log R)) from the 4 power-law parameters, in
    float32 on ``device``; non-finite values (the origin) become 1."""
    x0, y0, b1, b2 = (torch.tensor(float(v), dtype=torch.float32, device=device)
                      for v in np.asarray(p4, np.float32))
    x = torch.as_tensor(_param_log_radius(*shape), device=device)
    y = torch.where(x < x0, b1 * x + y0 - b1 * x0, b2 * x + y0 - b2 * x0)
    f = torch.exp(y)
    return torch.where(torch.isfinite(f), f, 1.0)


def _fit_powerlaw(psd, L, weighted):
    """Two-slope fit of the radial log-spectrum (SciPy, on the host)."""
    from scipy import optimize

    wn = np.arange(int(L / 2) + 1) if L % 2 == 1 else np.arange(int(L / 2))
    psd = psd[: len(wn)]
    logwn, logpsd = np.log(wn[1:]), np.log(np.maximum(psd[1:], 1e-40))
    if weighted:
        p0 = np.polyfit(logwn, logpsd, 1, w=np.sqrt(psd[1:]))
    else:
        p0 = np.polyfit(logwn, logpsd, 1)
    beta = p0[0]
    bounds = ([2.0, 0, -4, -4], [5.0, 20, -1.0, -1.0])
    # the polyfit seed clipped into the bounds: a flat or rising spectrum
    # gives beta > -1, and SciPy refuses an initial guess out of bounds
    seed = [2.0, float(np.clip(p0[1], 0.0, 20.0))] + [float(np.clip(beta, -4.0, -1.0))] * 2
    try:
        p, _ = optimize.curve_fit(
            lambda x, x0, y0, b1, b2: _piecewise_linear(x, x0, y0, b1, b2),
            logwn, logpsd, p0=seed, bounds=bounds,
            sigma=1 / np.sqrt(psd[1:]) if weighted else None,
        )
    except (RuntimeError, ValueError):
        p = np.array([2.0, p0[1], beta, beta])
    return p


def initialize_param_2d_fft_filter(field, device=None, **kwargs):
    """Fit a two-slope power law to the radially averaged spectrum of the
    input field(s) and build the isotropic parametric filter (full fft2
    plane).  The PSD and the filter are computed on the device; only the
    ~L/2-point radial profile goes to the host for the fit.

    kwargs: ``win_fun`` (None), ``model`` ("power-law"), ``weighted``
    (False), ``rm_rdisc`` (False)."""
    win_fun = kwargs.get("win_fun", None)
    model = kwargs.get("model", "power-law")
    weighted = kwargs.get("weighted", False)
    rm_rdisc = kwargs.get("rm_rdisc", False)
    if model.lower() != "power-law":
        raise ValueError(f"unknown parametric model {model}")
    dev = device_of(field, device)
    field = torch.as_tensor(field, device=dev)
    M, N = field.shape[-2:]
    psd = _param_psd(field, _taper(M, N, win_fun, dev, torch.float32), rm_rdisc=bool(rm_rdisc))
    p = _fit_powerlaw(psd.cpu().numpy(), max(M, N), weighted)
    pf = p.copy()
    pf[2:] = pf[2:] / 2  # amplitude = sqrt(power)
    return {
        "field": _param_filter(pf, (M, N), dev),
        "input_shape": (M, N),
        "use_full_fft": True,
        "model": "power-law",
        "pars": p,
    }


def _generator(filt, generator, seed):
    if generator is not None:
        return generator
    gen = torch.Generator(device=filt.device)
    gen.manual_seed(seed if seed is not None else 0)
    return gen


def generate_noise_2d_fft_filter(
    F, randstate=None, seed=None, fft_method=None, domain="spatial", generator=None
):
    """One standardized correlated-noise field (m, n) from a global filter,
    drawn from ``generator`` (else a generator seeded with ``seed``) on the
    filter's device; ``domain="spectral"`` returns its spectrum with the DC
    bin zeroed.  ``randstate`` and ``fft_method`` are accepted for the JAX
    package's signature and ignored."""
    if domain not in ("spatial", "spectral"):
        raise ValueError(f"invalid domain {domain}")
    filt = F["field"]
    return _generate_fft_noise(
        _generator(filt, generator, seed), filt, F["input_shape"], 1, domain=domain,
        use_full_fft=F["use_full_fft"],
    )[0]


def nonparam_filter_core(fields, taper):
    """Nonparametric noise filter: |mean rfft2(tapered field)| over a
    (p, m, n) stack, after closing each field's rain/no-rain gap and
    zeroing its minimum.  Returns (m, n//2+1)."""
    zerovalue = fields.amin(dim=(-2, -1), keepdim=True)
    wet = fields > zerovalue
    inf = torch.tensor(float("inf"), dtype=fields.dtype, device=fields.device)
    shift = torch.where(wet, fields, inf).amin(dim=(-2, -1), keepdim=True) - zerovalue
    f = torch.where(wet, fields - shift, fields)
    f = f - f.amin(dim=(-2, -1), keepdim=True)
    return torch.abs(torch.fft.rfft2(f * taper).mean(dim=0))


def _hermitianize(col):
    """Impose W[ky] = conj(W[-ky]) on a (..., m) spectral column, keeping
    the per-bin variance."""
    rev = torch.roll(torch.flip(col, dims=(-1,)), 1, dims=-1)
    return (col + torch.conj(rev)) / math.sqrt(2.0)


def _spectral_white(generator, input_shape, batch):
    """rfft2 of white N(0, 1) noise drawn directly in the half-plane:
    (batch, m, n//2+1) complex64."""
    m, n = input_shape
    rf = n // 2 + 1
    z = torch.randn(
        (batch, m, rf, 2), generator=generator, device=generator.device
    ) * math.sqrt(m * n / 2.0)
    W = torch.complex(z[..., 0], z[..., 1])
    W[..., :, 0] = _hermitianize(W[..., :, 0])
    if n % 2 == 0:
        W[..., :, -1] = _hermitianize(W[..., :, -1])
    return W


def _spectral_phase_white(generator, input_shape, batch, use_full_fft=False):
    """Unit-modulus random-phase spectrum (the spectral-domain draw):
    (batch, m, n//2+1) complex64 half-planes whose kx=0 column's phases are
    antisymmetric in ky, or with ``use_full_fft`` (batch, m, n) full planes
    with no constraint."""
    m, n = input_shape
    rf = n if use_full_fft else n // 2 + 1
    theta = torch.rand(
        (batch, m, rf), generator=generator, device=generator.device
    ) * (2.0 * math.pi)
    if not use_full_fft:
        hi = m // 2 if m % 2 == 0 else m // 2 + 1
        theta[:, m // 2 + 1 :, 0] = -torch.flip(theta[:, 1:hi, 0], dims=(-1,))
    return torch.polar(torch.ones_like(theta), theta)


def _white_normal(generator, input_shape, batch):
    """White N(0, 1) fields (batch, m, n) float32."""
    return torch.randn((batch,) + tuple(input_shape), generator=generator,
                       device=generator.device)


def _fft_noise_draw(generator, input_shape, batch, domain, use_full_fft):
    """The white draw of :func:`_generate_fft_noise`: random phases in the
    spectral domain, else white fields (full planes with ``use_full_fft``)
    or their half-plane spectra."""
    if domain == "spectral":
        if use_full_fft:
            return _spectral_phase_white(generator, input_shape, batch, use_full_fft=True)
        return _spectral_phase_white(generator, input_shape, batch)
    if domain != "spatial":
        raise ValueError(f"invalid domain {domain}")
    if use_full_fft:
        return _white_normal(generator, input_shape, batch)
    return _spectral_white(generator, input_shape, batch)


def _generate_fft_noise(
    generator, filt, input_shape, batch, domain="spatial", standardize=True,
    use_full_fft=False, keep=None,
):
    """White noise -> filter ``filt`` -> noise: an (m, n//2+1) half-plane
    filter, or an (m, n) full-plane one with ``use_full_fft``.

    ``domain="spatial"`` returns (batch, m, n) fields, ``"spectral"`` their
    spectra (rfft2 half-planes, or fft2 planes with ``use_full_fft``) with
    the DC bin zeroed.  ``standardize=False`` skips the final
    standardization, which a normalized cascade decomposition of the noise
    cancels anyway.  ``keep`` (a slice) keeps those members of the
    ``batch`` drawn: the generator advances through the whole draw."""
    white = _fft_noise_draw(generator, input_shape, batch, domain, use_full_fft)
    if keep is not None:
        white = white[keep]
    if domain == "spectral":
        fN = white * filt
        fN[..., 0, 0] = 0.0
        if not standardize:
            return fN
        return fN / spectral_utils.std(fN, input_shape, use_full_fft=use_full_fft)[..., None, None]
    if use_full_fft:
        N = torch.fft.ifft2(torch.fft.fft2(white) * filt).real
    else:
        N = torch.fft.irfft2(white * filt, s=tuple(input_shape))
    return _standardize(N) if standardize else N


def _window_indices(dim, n_windows, win_size, overlap):
    """(lo, hi) of each of ``n_windows`` windows of ``win_size`` along an
    axis of ``dim`` pixels, each widened by ``overlap`` x ``win_size``."""
    idx = []
    for i in range(n_windows):
        lo = int(max(i * win_size - overlap * win_size, 0))
        hi = int(min(lo + win_size + overlap * win_size, dim))
        idx.append((lo, hi))
    return idx


def _get_mask(size, idxi, idxj, win_fun, device=None):
    """A float64 zero plane of ``size`` holding the tapered window (plus
    1e-6; ones without ``win_fun``) at rows ``idxi``, columns ``idxj``."""
    win_size = (idxi[1] - idxi[0], idxj[1] - idxj[0])
    if win_fun is not None:
        wind = tapering_utils.compute_window_function(win_size[0], win_size[1], win_fun)
        wind += 1e-6
    else:
        wind = np.ones(win_size)
    mask = torch.zeros(tuple(size), dtype=torch.float64, device=device)
    mask[idxi[0] : idxi[1], idxj[0] : idxj[1]] = torch.as_tensor(wind, device=device)
    return mask


def _local_filters(field, windows, win_fun, war_thr):
    """The normalized |FFT| filter of the prepared stack ``field`` (p, m,
    n) under each window's mask, all windows in one batch, and whether each
    window's wet-area ratio (pixels above 0.01 per window pixel and field)
    passes ``war_thr``.  ``windows``: ((lo, hi) rows, (lo, hi) columns)."""
    nr, m, n = field.shape
    masks = torch.stack([_get_mask((m, n), wi, wj, win_fun, field.device)
                         for wi, wj in windows])
    local = field[None] * masks[:, None]  # (W, p, m, n)
    counts = (local > 0.01).sum(dim=(1, 2, 3)).cpu().numpy()
    areas = np.array([(wi[1] - wi[0]) * (wj[1] - wj[0]) * nr for wi, wj in windows])
    filt = _abs_spectrum(_prep_field(local, True).to(torch.float32), True, True)
    return filt, counts / areas > war_thr


def _global_filter(field, win_fun):
    """The normalized full-plane |FFT| filter of the whole stack."""
    return initialize_nonparam_2d_fft_filter(
        field, win_fun=win_fun, donorm=True, use_full_fft=True
    )["field"]


def initialize_nonparam_2d_ssft_filter(field, device=None, **kwargs):
    """Short-space Fourier transform filter: the normalized |FFT| of the
    input under each of overlapping tapered windows, where the window is
    wet enough (else the global filter).  Returns a filter dict whose
    "field" is the (wy, wx, m, n) stack.

    kwargs: ``win_size`` ((128, 128)), ``win_fun`` ("tukey"), ``overlap``
    (0.3), ``war_thr`` (0.1), ``rm_rdisc`` (True), ``overlap_gen`` (0.2,
    the generator's overlap)."""
    win_size = kwargs.get("win_size", (128, 128))
    if isinstance(win_size, int):
        win_size = (win_size, win_size)
    win_fun = kwargs.get("win_fun", "tukey")
    overlap = kwargs.get("overlap", 0.3)
    war_thr = kwargs.get("war_thr", 0.1)
    rm_rdisc = kwargs.get("rm_rdisc", True)
    dev = device_of(field, device)
    field = _prep_field(torch.as_tensor(field, device=dev), rm_rdisc)
    _, dim_y, dim_x = field.shape
    wy = int(np.ceil(dim_y / win_size[0]))
    wx = int(np.ceil(dim_x / win_size[1]))
    windows = [(wi, wj)
               for wi in _window_indices(dim_y, wy, win_size[0], overlap)
               for wj in _window_indices(dim_x, wx, win_size[1], overlap)]
    filt, ok = _local_filters(field, windows, win_fun, war_thr)
    ok = torch.as_tensor(ok, device=dev)[:, None, None]
    F = torch.where(ok, filt, _global_filter(field, win_fun))
    return {
        "field": F.reshape(wy, wx, dim_y, dim_x),
        "input_shape": (dim_y, dim_x),
        "use_full_fft": True,
        "win_fun": win_fun,
        "overlap_gen": kwargs.get("overlap_gen", 0.2),
    }


def _split(idxi, idxj, segments):
    """Split a window into segments x segments equal windows (the remainder
    of an uneven split dropped)."""
    si = (idxi[1] - idxi[0]) // segments
    sj = (idxj[1] - idxj[0]) // segments
    out_i, out_j = [], []
    for a in range(segments):
        for b in range(segments):
            i0 = idxi[0] + a * si
            j0 = idxj[0] + b * sj
            out_i.append((i0, min(i0 + si, idxi[1])))
            out_j.append((j0, min(j0 + sj, idxj[1])))
    return out_i, out_j


def initialize_nonparam_2d_nested_filter(field, gridres=1.0, device=None, **kwargs):
    """Nested filter: the global filter refined level by level over a
    quad-tree of windows, each wet window's filter blended in above a
    frequency set by its size.  Returns a filter dict whose "field" is the
    (2^max_level, 2^max_level, m, n) stack.

    kwargs: ``max_level`` (3), ``win_fun`` ("tukey"), ``war_thr`` (0.1),
    ``rm_rdisc`` (True), ``overlap_gen`` (0.2)."""
    max_level = kwargs.get("max_level", 3)
    win_fun = kwargs.get("win_fun", "tukey")
    war_thr = kwargs.get("war_thr", 0.1)
    rm_rdisc = kwargs.get("rm_rdisc", True)
    dev = device_of(field, device)
    field = _prep_field(torch.as_tensor(field, device=dev), rm_rdisc)
    _, dim_y, dim_x = field.shape

    fx, fy = np.meshgrid(np.fft.fftfreq(dim_x, gridres), np.fft.fftfreq(dim_y, gridres))
    freq_grid = np.sqrt(fx**2 + fy**2)

    def merge_weights(x0):
        kshape = 0.05
        with np.errstate(divide="ignore"):
            merge = 1 / (1 + np.exp(-kshape * (1 / freq_grid - x0 * gridres)))
        merge[freq_grid == 0] = 1.0
        return torch.as_tensor(merge, device=dev)

    side = 2**max_level
    F = _global_filter(field, win_fun).expand(side, side, dim_y, dim_x).clone()
    level = 0
    Idxi, Idxj = [(0, dim_y)], [(0, dim_x)]
    Idxipsd, Idxjpsd = [(0, side)], [(0, side)]
    while level < max_level:
        children = []
        for k in range(len(Idxi)):
            Ii, Ij = _split(Idxi[k], Idxj[k], 2)
            Pi, Pj = _split(Idxipsd[k], Idxjpsd[k], 2)
            children += list(zip(Ii, Ij, Pi, Pj))
        filt, ok = _local_filters(field, [c[:2] for c in children], win_fun, war_thr)
        merges = {}
        for c, (wi, _, pi, pj) in enumerate(children):
            if not ok[c]:
                continue
            x0 = (wi[1] - wi[0]) / 2.0
            if x0 not in merges:
                merges[x0] = merge_weights(x0)
            merge = merges[x0]
            # float32 filters scaled in float64, as numpy's in-place update
            new = (filt[c].double() * (1 - merge)).float()
            sl = F[pi[0] : pi[1], pj[0] : pj[1]]
            F[pi[0] : pi[1], pj[0] : pj[1]] = (sl.double() * merge).float() + new
        level += 1
        Idxi, Idxj = _split((0, dim_y), (0, dim_x), 2**level)
        Idxipsd, Idxjpsd = _split((0, side), (0, side), 2**level)

    return {
        "field": F,
        "input_shape": (dim_y, dim_x),
        "use_full_fft": True,
        "win_fun": win_fun,
        "overlap_gen": kwargs.get("overlap_gen", 0.2),
    }


def _ssft_gen_masks(filter_shape, input_shape, overlap, win_fun, device=None):
    """The generator's (wy, wx, m, n) float32 composition masks of a
    filter stack of shape ``filter_shape``."""
    wy, wx = filter_shape[:2]
    dim_y, dim_x = input_shape
    masks = torch.stack([
        _get_mask((dim_y, dim_x), wi, wj, win_fun, device)
        for wi in _window_indices(dim_y, wy, dim_y / wy, overlap)
        for wj in _window_indices(dim_x, wx, dim_x / wx, overlap)
    ])
    return masks.to(torch.float32).reshape(wy, wx, dim_y, dim_x)


def generate_noise_2d_ssft_filter(F, randstate=None, seed=None, generator=None, **kwargs):
    """One standardized field (m, n) of locally correlated noise from an
    SSFT or nested filter stack, drawn from ``generator`` (else a generator
    seeded with ``seed``) on the filter's device.  kwargs: ``overlap`` and
    ``win_fun`` of the composition (the filter's "overlap_gen" and
    "win_fun" by default); spatial domain only."""
    if kwargs.get("domain", "spatial") == "spectral":
        raise NotImplementedError("SSFT noise is spatial-domain only")
    overlap = kwargs.get("overlap", F.get("overlap_gen", 0.2))
    win_fun = kwargs.get("win_fun", F.get("win_fun", "tukey"))
    filt = F["field"]
    masks = _ssft_gen_masks(filt.shape, F["input_shape"], overlap, win_fun, filt.device)
    return _generate_ssft_noise(
        _generator(filt, generator, seed), filt, masks, F["input_shape"], 1
    )[0]


def _generate_ssft_noise(generator, filt, masks, input_shape, batch, keep=None):
    """(batch, m, n) standardized SSFT noise: each white field's spectrum
    times every window's filter (wy, wx, m, n), one batched inverse FFT,
    composed with the window ``masks`` and divided by their sum.  The white
    fields are drawn for the whole batch first (``keep``, a slice, keeps
    those members of it); members then go through in chunks whose complex
    intermediate stays within ``_SSFT_CHUNK_BYTES``."""
    m, n = input_shape
    white = _white_normal(generator, input_shape, batch)
    if keep is not None:
        white = white[keep]
        batch = white.shape[0]
    n_win = filt.shape[0] * filt.shape[1]
    filt = filt.reshape(n_win, m, n)
    masks = masks.reshape(n_win, m, n)
    chunk = max(1, _SSFT_CHUNK_BYTES // (n_win * m * n * 8))
    parts = []
    for c0 in range(0, batch, chunk):
        fN = torch.fft.fft2(white[c0 : c0 + chunk])
        flN = torch.fft.ifft2(fN[:, None] * filt).real
        parts.append((flN * masks).sum(dim=1))
    cN = torch.cat(parts)
    sM = masks.sum(dim=0)
    cN = torch.where(sM > 0, cN / torch.where(sM > 0, sM, 1.0), cN)
    return _standardize(cN)
