"""Plain reference of the STEPS nowcast entry.

Written from the algorithm (Seed 2003; Bowler, Seed and Mead 2006;
pysteps' ``nowcasts.steps``, Pulkkinen et al. 2019) as the port states it
for the configurations of the benchmark, in float64 PyTorch, one
operation after another, with no hand-written kernel and nothing of the
port.  What it shares with the port are the inputs and the seeded draws:
it draws them itself from a ``torch.Generator`` on the forecast's device
seeded with the request's seed, in the order the port draws them (the two
BPS Laplace numbers of every member, then a lead's random phases of every
member).

A forecast:

1. the three frames' non-finite pixels take the smallest finite value;
2. the two older frames are carried to the newest one's time along the
   flow (backward semi-Lagrangian, midpoint rule, one and two steps);
3. each aligned frame splits into k Gaussian bandpass levels (log-spaced
   in wavenumber, weights summing to one, the mean in level 0), each
   standardized; per level the lag-1 and lag-2 correlations with the
   newest frame give an AR(2) model (the lag-2 correlation moved into the
   stationary region, then Yule-Walker);
4. the noise filter is the modulus of the mean spectrum of the aligned
   frames, each with its rain/no-rain gap closed and its minimum zeroed,
   under a Tukey window;
5. every member draws two Laplace numbers: its flow's perturbation along
   and across the flow (BPS, Bowler et al. 2006);
6. at each lead every member draws a phase for each bin of the half-plane
   spectrum; its noise is the filter with those phases, split into the k
   levels and standardized; the AR(2) step advances the levels' spectra;
   the field is the sum of the levels times the newest frame's level
   stds, plus its level means; the field is squeezed towards its minimum
   by the member's incremental mask; its empirical CDF is matched to the
   newest frame's; the mask of the next lead is the buffered rain of the
   matched field; the member's displacement advances one step along its
   perturbed flow, and the matched field is carried back along it.

The displacement and the field warp follow the port's rule: on the card,
for a grid of at least 3 x 48 pixels a side, the sampling is separable
(a linear resample along the columns, then along the rows, each source
index held within 48 pixels of the target); elsewhere it is the joint
bilinear gather.  The CDF match is the port's sort match on value
quantized to the bits that a 32-bit (value, pixel) key leaves.  A
configuration on which the port takes another path (the 4x coarse
displacement, the piecewise-linear match) is refused.
"""

import math

import numpy as np
import torch

F64 = torch.float64
BOUND_PX = 48  # the port's static displacement bound on the card
TUKEY_ALPHA = 0.2
GAUSS_SCALE = 0.5
BPS_PAR = (10.88, 0.23, -7.68)  # Bowler, Pierce and Seed (2006), along the flow
BPS_PERP = (5.76, 0.31, -2.72)  # across it
MASK_RIM = 10
LAPLACE_LO, LAPLACE_HI = -0.5 + 1e-7, 0.5 - 1e-7


# --- sampling ------------------------------------------------------------

def _lerp_along(f, pos, D, axis):
    """Sample ``f`` (..., m, n) along ``axis`` (-2: down the columns, -1:
    along the rows) at the fractional positions ``pos`` (..., m, n): the
    lower tap's index is held within ``D`` of the target's own index (no
    bound for None), both taps are clamped to the grid, then linear."""
    size = f.shape[axis]
    own = torch.arange(size, device=f.device)
    own = own[:, None] if axis == -2 else own[None, :]
    base = torch.floor(pos)
    w = pos - base
    k = base.long()
    if D is not None:
        k = torch.minimum(torch.maximum(k, own - D), own + D)
    lo = torch.gather(f.expand(pos.shape), axis, k.clamp(0, size - 1))
    hi = torch.gather(f.expand(pos.shape), axis, (k + 1).clamp(0, size - 1))
    return lo * (1.0 - w) + hi * w


def _bilinear(f, cy, cx):
    """The joint bilinear sample of ``f`` (..., m, n) at (cy, cx), taps
    clamped to the grid."""
    m, n = f.shape[-2:]
    y0, x0 = torch.floor(cy), torch.floor(cx)
    wy, wx = cy - y0, cx - x0
    y0, x0 = y0.long(), x0.long()
    flat = f.expand(cy.shape).reshape(-1, m * n)

    def at(y, x):
        idx = y.clamp(0, m - 1) * n + x.clamp(0, n - 1)
        return torch.gather(flat, 1, idx.reshape(flat.shape[0], -1)).reshape(cy.shape)

    top = at(y0, x0) * (1.0 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1.0 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def sample(f, disp, bound, fill=None):
    """``f`` (..., m, n) read at each pixel displaced by ``disp`` (..., 2, m,
    n), x first: separably with each source index held within ``bound``
    pixels, or by the joint bilinear gather where ``bound`` is None.
    Samples whose position lies outside the grid take ``fill``, or the
    clamped edge where ``fill`` is None."""
    m, n = f.shape[-2:]
    cy = torch.arange(m, dtype=F64, device=f.device)[:, None] + disp[..., 1, :, :]
    cx = torch.arange(n, dtype=F64, device=f.device)[None, :] + disp[..., 0, :, :]
    if bound is not None:
        out = _lerp_along(_lerp_along(f, cy, bound, -2), cx, bound, -1)
    else:
        out = _bilinear(f, cy, cx)
    if fill is not None:
        inside = (cy >= 0) & (cy <= m - 1) & (cx >= 0) & (cx <= n - 1)
        out = torch.where(inside, out, torch.full_like(out, fill))
    return out


def advance(velocity, disp, bound):
    """One unit step of the backward displacement ``disp`` (..., 2, m, n)
    along ``velocity`` (..., 2, m, n), by the midpoint rule, sampling as
    :func:`sample` does with ``bound``."""

    def vel_at(d):
        return torch.stack([sample(velocity[..., c, :, :], d, bound)
                            for c in range(2)], dim=-3)

    half = vel_at(disp)
    return disp - vel_at(disp - half / 2.0)


# --- the cascade -------------------------------------------------------------

def bandpass_weights(m, n, k, device):
    """(k, m, n//2+1) Gaussian bandpass weights over the rfft2 half-plane:
    level centres log-spaced between 1 and half the longer side, Gaussian
    in log wavenumber, normalized to sum to one in every bin; the mean (the
    zero bin) belongs to level 0 alone."""
    q = (0.5 * max(m, n)) ** (1.0 / k)
    centres = [0.5 * (q ** (j - 1) + q ** j) for j in range(1, k + 1)]
    ky = np.abs(np.fft.fftfreq(m) * m)
    kx = np.arange(n // 2 + 1)
    r = np.hypot(ky[:, None], kx[None, :])
    log_r = np.log(np.where(r > 0, r, 1.0)) / np.log(q)
    w = np.stack([np.exp(-(log_r - math.log(c) / math.log(q)) ** 2
                         / (2.0 * GAUSS_SCALE ** 2)) for c in centres])
    w /= w.sum(axis=0, keepdims=True)
    w[:, 0, 0] = 0.0
    w[0, 0, 0] = 1.0
    return torch.tensor(w, dtype=F64, device=device)


def split_levels(fields, weights):
    """(F, m, n) fields split into standardized levels (F, k, m, n), with
    each level's mean and (population) std (F, k)."""
    m, n = fields.shape[-2:]
    spec = torch.fft.rfft2(fields)
    levels = torch.fft.irfft2(spec[:, None] * weights, s=(m, n))
    mean = levels.mean(dim=(-2, -1))
    std = levels.std(dim=(-2, -1), correction=0)
    return (levels - mean[..., None, None]) / std[..., None, None], mean, std


def half_plane_power(spec, n):
    """Sum of |X|^2 over the full plane of the rfft2 half-planes ``spec``
    (..., m, n//2+1): the columns without a mirror once, the rest twice."""
    p = spec.real ** 2 + spec.imag ** 2
    last = n // 2 if n % 2 == 0 else None
    twice = p[..., :, 1:last].sum(dim=(-2, -1))
    once = p[..., :, 0].sum(dim=-1) + (p[..., :, last].sum(dim=-1) if last else 0.0)
    return once + 2.0 * twice


def ar2_parameters(levels):
    """(k, 3) AR(2) parameters [phi_1, phi_2, sigma] of each level from the
    standardized levels (3, k, m, n) of the aligned frames (oldest first)."""

    def corr(a, b):
        a = a - a.mean(dim=(-2, -1), keepdim=True)
        b = b - b.mean(dim=(-2, -1), keepdim=True)
        return (a * b).sum(dim=(-2, -1)) / torch.sqrt(
            (a * a).sum(dim=(-2, -1)) * (b * b).sum(dim=(-2, -1)))

    g1 = corr(levels[2], levels[1])
    g2 = corr(levels[2], levels[0])
    # lag-2 correlation moved into the region where the AR(2) is stationary
    c1 = g1.clamp(-0.9999, 0.9999)
    g2 = torch.maximum(g2, 2.0 * c1 * g2 - 1.0)
    g2 = torch.maximum(g2, (3.0 * c1 ** 2 - 2.0 + 2.0 * (1.0 - c1 ** 2) ** 1.5)
                       / (c1 ** 2).clamp(min=1e-8))
    # Yule-Walker, with |gamma| kept below 0.9985
    g1, g2 = g1.clamp(-0.9985, 0.9985), g2.clamp(-0.9985, 0.9985)
    phi1 = g1 * (1.0 - g2) / (1.0 - g1 ** 2)
    phi2 = (g2 - g1 ** 2) / (1.0 - g1 ** 2)
    sigma = torch.sqrt((1.0 - g1 * phi1 - g2 * phi2).clamp(min=0.0))
    return torch.stack([phi1, phi2, sigma], dim=1)


def tukey(m, n, device):
    """The radial Tukey window (alpha 0.2) of an (m, n) grid."""
    yy, xx = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    R = np.hypot(xx / n - 0.5, yy / m - 0.5)
    W = np.ones((m, n))
    ramp = (R > 0.5 * (1.0 - TUKEY_ALPHA)) & (R < 0.5)
    W[ramp] = 0.5 * (1.0 + np.cos(np.pi * (R[ramp] / (TUKEY_ALPHA / 2.0)
                                           - 1.0 / TUKEY_ALPHA + 1.0)))
    W[R >= 0.5] = 0.0
    return torch.tensor(W, dtype=F64, device=device)


def noise_filter(aligned):
    """|mean spectrum| of the aligned frames (F, m, n), each with its
    rain/no-rain gap closed and its minimum zeroed, under the Tukey window."""
    specs = []
    for f in aligned:
        low = f.min()
        wet = f > low
        if bool(wet.any()):
            f = torch.where(wet, f - (f[wet].min() - low), f)
        specs.append(torch.fft.rfft2((f - f.min()) * tukey(*f.shape, f.device)))
    return torch.stack(specs).mean(dim=0).abs()


# --- per lead ------------------------------------------------------------

def buffered_rain(wet, kr, r):
    """The incremental mask of wet pixels (B, m, n): kr dilations by the
    4-neighbour cross, then r more, each adding one; over r + 1."""
    cur = wet.clone()
    acc = cur.to(F64) if kr == 0 else torch.zeros(wet.shape, dtype=F64, device=wet.device)
    for step in range(1, kr + r + 1):
        grown = cur.clone()
        grown[..., 1:, :] |= cur[..., :-1, :]
        grown[..., :-1, :] |= cur[..., 1:, :]
        grown[..., :, 1:] |= cur[..., :, :-1]
        grown[..., :, :-1] |= cur[..., :, 1:]
        cur = grown
        if step >= kr:
            acc += cur.to(F64)
    return acc / (r + 1.0)


def cdf_match(fields, target):
    """Each member of ``fields`` (B, m, n) given the empirical distribution
    of ``target`` (m, n): where the target is wetter than the member, its
    values below the member's wet-share quantile become its minimum; pixels
    are ranked by value quantized to the bits a 32-bit (value, pixel) key
    leaves, ties by pixel, and take the (equally quantized) target value of
    their rank; pixels at the member's minimum take the target's."""
    B = fields.shape[0]
    x = fields.reshape(B, -1)
    size = x.shape[1]
    ranked = torch.sort(target.reshape(-1)).values
    t_min = ranked[0]
    x_min = x.min(dim=1, keepdim=True).values
    n_wet = (x > x_min).sum(dim=1)
    n_wet_t = int((ranked > t_min).sum())
    idx_bits = max((size - 1).bit_length(), 1)
    levels = 2 ** (32 - idx_bits) - 1
    pixel = torch.arange(size, device=x.device)
    out = torch.empty_like(x)
    for b in range(B):
        tb = ranked
        if n_wet_t > int(n_wet[b]):
            share = float(n_wet[b]) / size
            p = ranked[min(max(round((1.0 - share) * (size - 1)), 0), size - 1)]
            tb = torch.where(ranked < p, t_min, ranked)
        lo, hi = x[b].min(), x[b].max()
        qx = torch.round((x[b] - lo) * (levels / (hi - lo).clamp(min=1e-12))).long()
        order = torch.sort(qx * size + pixel).values % size
        tlo, thi = tb[0], tb[-1]
        tscale = levels / (thi - tlo).clamp(min=1e-12)
        tq = torch.round((tb - tlo) * tscale)
        out[b, order] = tq / tscale + tlo
        out[b] = torch.where(x[b] == x_min[b], t_min, out[b])
    return out.reshape(fields.shape)


def laplace(gen, count):
    """``count`` Laplace(0, 1/sqrt(2)) numbers by the inverse CDF of the
    uniforms drawn from ``gen``."""
    u = torch.rand((count,), generator=gen, device=gen.device).to(F64)
    u = u * (LAPLACE_HI - LAPLACE_LO) + LAPLACE_LO
    return -torch.sign(u) * torch.log(1.0 - 2.0 * u.abs()) / math.sqrt(2.0)


def phases(gen, E, m, n):
    """(E, m, n//2+1) random phases, the zero column's antisymmetric in
    the vertical wavenumber (its mirror rows are the negated draws)."""
    theta = torch.rand((E, m, n // 2 + 1), generator=gen, device=gen.device).to(F64)
    theta = theta * (2.0 * math.pi)
    hi = m // 2 if m % 2 == 0 else m // 2 + 1
    theta[:, m // 2 + 1:, 0] = -torch.flip(theta[:, 1:hi, 0], dims=(-1,))
    return torch.polar(torch.ones_like(theta), theta)


# --- the forecast ------------------------------------------------------------

def card_path(device, m, n):
    """The port's sampling bound on ``device`` (None: the joint bilinear
    gather); raises where it takes a path on the card that this reference
    does not follow."""
    if torch.device(device).type != "cuda":
        return None
    if min(m, n) < 3 * BOUND_PX:
        raise NotImplementedError("the port bounds this grid's displacement by the flow")
    if m % 4 == 0 and n % 4 == 0:
        raise NotImplementedError("the port carries this grid's displacement 4x coarse")
    if (m * n) % 1024 == 0:
        raise NotImplementedError("the port matches this grid's CDF piecewise-linearly")
    return BOUND_PX


def steps(frames, velocity, leads, members, levels, thr, timestep, km_per_px, seed,
          device):
    """The STEPS ensemble (E, T, m, n) float64 of ``frames`` (3, m, n) and
    ``velocity`` (2, m, n), host arrays in dB and pixels a step."""
    device = torch.device(device)
    precip = np.asarray(frames, dtype=np.float32)[-3:]
    outside = torch.tensor(~np.isfinite(precip[-1]), device=device)
    precip = np.where(np.isfinite(precip), precip, np.nanmin(precip))
    x = torch.tensor(precip, dtype=F64, device=device)
    vel = torch.tensor(np.asarray(velocity, dtype=np.float32), dtype=F64, device=device)
    m, n = x.shape[-2:]
    bound = card_path(device, m, n)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    # alignment: the older frames carried one and two steps
    zero = torch.zeros_like(vel)
    d1 = advance(vel, zero, bound)
    d2 = advance(vel, d1, bound)
    disp = torch.stack([d2, d1, zero])
    aligned = sample(x, disp, bound, fill=float(x.min()))

    weights = bandpass_weights(m, n, levels, device)
    std_levels, mean, std = split_levels(aligned, weights)
    phi = ar2_parameters(std_levels)
    lag_old = torch.fft.rfft2(std_levels[1])[None]  # (1, k, m, n//2+1)
    lag_new = torch.fft.rfft2(std_levels[2])[None]
    mean_last, std_last = mean[2], std[2]
    filt = noise_filter(aligned)

    kr = max(int((1.0 * timestep / km_per_px - 1) / 2.0), 1)
    mask = buffered_rain((x[-1] >= thr)[None], kr, MASK_RIM).expand(members, m, n)
    eps_par = laplace(gen, members)
    eps_perp = laplace(gen, members)
    speed = torch.linalg.vector_norm(vel, dim=0)
    v_par = torch.where(speed > 1e-12, vel / speed.clamp(min=1e-12), 0.0)
    v_perp = torch.stack([-v_par[1], v_par[0]])
    vsf = 60.0 / (timestep / km_per_px)
    target = x[-1]

    w = weights[None]
    size = float(m * n)
    phi1, phi2, sigma = (phi[:, j, None, None] for j in range(3))
    disp = torch.zeros((members, 2, m, n), dtype=F64, device=device)
    out = torch.empty((members, leads, m, n), dtype=F64, device=device)
    for t in range(leads):
        # noise: the filter under random phases, split and standardized
        noise = phases(gen, members, m, n) * filt
        noise[:, 0, 0] = 0.0
        eps = noise[:, None] * w
        eps_mean = eps[..., 0, 0].real / size
        eps_std = torch.sqrt((half_plane_power(eps, n) - eps[..., 0, 0].real ** 2)) / size
        eps[..., 0, 0] -= eps_mean * size
        eps = eps / eps_std[..., None, None]
        new = phi1 * lag_new + phi2 * lag_old + sigma * eps
        lag_old, lag_new = lag_new, new
        spec = (new * std_last[:, None, None]).sum(dim=1)
        spec[:, 0, 0] += mean_last.sum() * size
        field = torch.fft.irfft2(spec, s=(m, n))

        low = field.amin(dim=(-2, -1), keepdim=True)
        field = low + (field - low) * mask
        field = torch.where(field > low, field, low)

        minutes = (t + 1.0) * timestep
        g_par = BPS_PAR[0] * minutes ** BPS_PAR[1] + BPS_PAR[2]
        g_perp = BPS_PERP[0] * minutes ** BPS_PERP[1] + BPS_PERP[2]
        vel_e = vel + (eps_par[:, None, None, None] * g_par * v_par
                       + eps_perp[:, None, None, None] * g_perp * v_perp) / vsf
        disp = advance(vel_e, disp, bound)

        field = cdf_match(field, target)
        mask = buffered_rain(field >= thr, kr, MASK_RIM)
        moved = sample(field, disp, bound, fill=float("nan"))
        out[:, t] = torch.where(outside, float("nan"), moved)
    return out


def forecast(request, config, seed, device):
    """The reference forecast of ``request``'s frames along its velocity
    (host numpy), (E, T, m, n) on ``device``."""
    kw = config["kwargs"]
    return steps(request["frames"], request["velocity"], int(config["leads"]),
                 int(kw["n_ens_members"]), int(kw["n_cascade_levels"]), float(kw["precip_thr"]),
                 float(kw["timestep"]), float(kw["kmperpixel"]), seed, device)
