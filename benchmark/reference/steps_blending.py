"""Plain reference of the STEPS blending entry.

Written from the algorithm (Bowler, Seed and Mead 2006; Imhoff et al.
2023, pysteps' ``blending.steps``) as the port states it for the
configurations of the benchmark, in float64 PyTorch, with the nowcast
reference's cascade, sampling, noise filter, mask and Laplace draws
(``steps_nowcast``) and nothing of the port.  It draws the seeded numbers
itself, in the port's order: the BPS Laplace numbers from a generator
seeded with the seed plus 7; a lead's white noise of every member, then a
lead's uniforms of the resampled target, from one seeded with the seed.

A forecast (one NWP model):

1. the radar frames' and the NWP fields' non-finite pixels take the
   radar's smallest finite value;
2. the older radar frames are aligned to the newest (joint bilinear) and
   split into standardized levels; an AR(2) model a level; the NWP fields
   of every lead are split into standardized levels too;
3. the NWP skill at the start is each level's correlation of the newest
   radar cascade with the NWP's at lead 0 over the radar domain; at lead
   time lt it decays towards the climatological skill (BPS2006's defaults
   where no skill file is kept) by exp(-lt/a) (2 - exp(-lt/b)); the
   extrapolation's skill decays as the AR(2) process's autocorrelation;
4. a lead's weights are BPS2006's: each component's correlation times the
   root of its share of the explained-variance ratios, the noise the rest
   of the unit variance; the advection is the blend of the radar and NWP
   flows by the second level's weights;
5. each lead: the extrapolation cascade takes an AR(2) step without noise,
   each member's noise cascade one with its new white noise (the filter
   under Hermitian white Gaussian spectra, split and standardized); the
   member's displacement advances one step along the blended flow, BPS-
   perturbed along and across it; the weighted extrapolation and noise
   levels are summed and carried back along it (zero outside), the
   weighted NWP levels and the blended means added; the field is squeezed
   towards its minimum by the incremental mask, then matched to a target
   that takes each rank from the radar's or the NWP's sorted values, the
   radar's with the extrapolation's share of the skill weights; the next
   mask is the buffered rain of the matched field.
"""

import math

import numpy as np
import torch

from benchmark.reference.steps_nowcast import (
    BOUND_PX,
    BPS_PAR,
    BPS_PERP,
    F64,
    MASK_RIM,
    advance,
    ar2_parameters,
    bandpass_weights,
    buffered_rain,
    laplace,
    noise_filter,
    sample,
    split_levels,
)

# BPS2006's climatological skill a level, and the decay times (a, b) in minutes
CLIM_SKILL = (0.848, 0.537, 0.237, 0.065, 0.020, 0.0044, 0.0052, 0.0040)
DECAY = ((130.0, 165.0, 120.0, 55.0, 50.0, 15.0, 15.0, 10.0),
         (155.0, 220.0, 200.0, 75.0, 10e4, 10e4, 10e4, 10e4))
VEL_SEED_OFFSET = 7


def skill_weights(rho_ext, rho_nwp):
    """(3, k) BPS2006 weights [extrapolation, NWP, noise] of the two
    components' correlations (k,) each."""
    c = np.maximum(np.stack([rho_ext, rho_nwp]), 1e-4)
    ratio = c ** 2 / (1.0 - c ** 2)
    w = c * np.sqrt(ratio / ratio.sum(axis=0))
    return np.concatenate([w, np.sqrt(np.maximum(1.0 - (w ** 2).sum(axis=0), 0.0))[None]])


def domain_correlation(a, b, inside):
    """Each level's correlation of ``a`` and ``b`` (k, m, n) over ``inside``."""
    w = inside.to(F64)
    cnt = w.sum().clamp(min=1.0)
    a = a - (a * w).sum(dim=(-2, -1), keepdim=True) / cnt
    b = b - (b * w).sum(dim=(-2, -1), keepdim=True) / cnt
    r = (a * b * w).sum(dim=(-2, -1)) / torch.sqrt(
        (a * a * w).sum(dim=(-2, -1)) * (b * b * w).sum(dim=(-2, -1))).clamp(min=1e-12)
    return np.nan_to_num(r.cpu().numpy(), nan=1e-4, posinf=1e-4, neginf=1e-4)


def white_spectra(gen, E, m, n):
    """(E, m, n//2+1) spectra of white unit Gaussian fields: standard
    normal real and imaginary parts scaled by sqrt(m n / 2), the zero
    column (and the last, for even n) made Hermitian in the vertical
    wavenumber keeping each bin's variance."""
    z = torch.randn((E, m, n // 2 + 1, 2), generator=gen, device=gen.device).to(F64)
    z = z * math.sqrt(m * n / 2.0)
    W = torch.complex(z[..., 0], z[..., 1])
    cols = [0, n // 2] if n % 2 == 0 else [0]
    for c in cols:
        col = W[..., :, c]
        mirror = torch.roll(torch.flip(col, dims=(-1,)), 1, dims=-1)
        W[..., :, c] = (col + torch.conj(mirror)) / math.sqrt(2.0)
    return W


def card_bound(device, vmax, leads, timestep, vsf, m, n):
    """The port's sampling bound on ``device`` (None: the joint bilinear
    gather): on the card the leads times the largest blended speed with a
    4-sigma BPS margin, plus 2 px, at most 48 (None where that passes a
    third of the grid).  Raises where the port takes a path on the card
    that this reference does not follow."""
    if torch.device(device).type != "cuda":
        return None
    if m % 4 == 0 and n % 4 == 0:
        raise NotImplementedError("the port carries this grid's displacement 4x coarse")
    t_last = leads * timestep
    margin = 4.0 * max(abs(BPS_PAR[0] * t_last ** BPS_PAR[1] + BPS_PAR[2]),
                       abs(BPS_PERP[0] * t_last ** BPS_PERP[1] + BPS_PERP[2])) / vsf
    bound = min(max(int(math.ceil(leads * (vmax + margin))) + 2, 2), BOUND_PX)
    return None if bound > min(m, n) // 3 else bound


def blend(frames, nwp, velocity, leads, members, levels, thr, timestep, km_per_px, seed,
          device):
    """The blended ensemble (E, T, m, n) float64 of the radar ``frames``
    (3, m, n) and one NWP model's fields ``nwp`` (1, T + 1, m, n), both
    moving along ``velocity`` (2, m, n); host arrays in dB and pixels a
    step."""
    device = torch.device(device)
    precip = np.asarray(frames, dtype=np.float32)[-3:]
    outside = torch.tensor(~np.isfinite(precip[-1]), device=device)
    low = float(np.nanmin(precip))
    precip = np.where(np.isfinite(precip), precip, low)
    nwp = np.asarray(nwp, dtype=np.float32)[0, : leads + 1]
    nwp = np.where(np.isfinite(nwp), nwp, low)
    x = torch.tensor(precip, dtype=F64, device=device)
    y = torch.tensor(nwp, dtype=F64, device=device)
    vel = torch.tensor(np.asarray(velocity, dtype=np.float32), dtype=F64, device=device)
    m, n = x.shape[-2:]

    # radar: aligned by the joint gather, split, AR(2); NWP: split
    zero = torch.zeros_like(vel)
    d1 = advance(vel, zero, None)
    d2 = advance(vel, d1, None)
    aligned = sample(x, torch.stack([d2, d1, zero]), None, fill=float(x.min()))
    weights = bandpass_weights(m, n, levels, device)
    radar, r_mean, r_std = split_levels(aligned, weights)
    phi = ar2_parameters(radar)
    nwp_levels, n_mean, n_std = split_levels(y, weights)
    filt = noise_filter(aligned)

    # skills and weights a lead
    rho0 = domain_correlation(radar[2], nwp_levels[0], ~outside)
    clim = np.array((CLIM_SKILL + (1e-4,) * levels)[:levels])
    a, b = (np.array((d + (d[-1],) * levels)[:levels]) for d in DECAY)
    ph = phi.cpu().numpy()
    prev, cur = np.ones(levels), ph[:, 0] / (1.0 - ph[:, 1])
    w_t = []
    for t in range(leads):
        rho_ext = ph[:, 0] * cur + ph[:, 1] * prev  # the AR(2)'s autocorrelation at lag t + 1
        prev, cur = cur, rho_ext
        lt = (t + 1) * timestep
        q = np.exp(-lt / a) * (2.0 - np.exp(-lt / b))
        w_t.append(skill_weights(rho_ext, q * rho0 + (1.0 - q) * clim))
    w_t = torch.tensor(np.stack(w_t), dtype=F64, device=device)  # (T, 3, k)
    # the blend of the radar's and the NWP's flows (here the same) by level 1's weights
    w_vel = w_t[:, :2, 1].sum(dim=1)
    vel_t = vel[None] * (w_vel / w_vel.clamp(min=1e-12))[:, None, None, None]

    kr = max(int((1.0 * timestep / km_per_px - 1) / 2.0), 1)
    mask = buffered_rain((x[-1] >= thr)[None], kr, MASK_RIM).expand(members, m, n)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    gen_vel = torch.Generator(device=device)
    gen_vel.manual_seed(int(seed) + VEL_SEED_OFFSET)
    eps_par = laplace(gen_vel, members)[:, None, None, None]
    eps_perp = laplace(gen_vel, members)[:, None, None, None]
    vsf = 60.0 / (timestep / km_per_px)
    bound = card_bound(device, float(vel_t.abs().max()), leads, timestep, vsf, m, n)
    radar_desc = torch.sort(x[-1].reshape(-1), descending=True).values
    nwp_desc = torch.sort(y[1:].reshape(leads, -1), dim=1, descending=True).values

    phi1, phi2, sigma = (phi[:, j, None, None] for j in range(3))
    ext_old, ext_new = radar[1], radar[2]
    noise_old = noise_new = torch.zeros((members, levels, m, n), dtype=F64, device=device)
    disp = torch.zeros((members, 2, m, n), dtype=F64, device=device)
    out = torch.empty((members, leads, m, n), dtype=F64, device=device)
    for t in range(leads):
        ext_old, ext_new = ext_new, phi1 * ext_new + phi2 * ext_old
        eps = torch.fft.irfft2(white_spectra(gen, members, m, n) * filt, s=(m, n))
        eps = split_levels(eps, weights)[0]
        noise_old, noise_new = noise_new, phi1 * noise_new + phi2 * noise_old + sigma * eps

        minutes = (t + 1.0) * timestep
        g_par = BPS_PAR[0] * minutes ** BPS_PAR[1] + BPS_PAR[2]
        g_perp = BPS_PERP[0] * minutes ** BPS_PERP[1] + BPS_PERP[2]
        v = vel_t[t]
        speed = torch.linalg.vector_norm(v, dim=0)
        v_par = torch.where(speed > 1e-12, v / speed.clamp(min=1e-12), 0.0)
        v_perp = torch.stack([-v_par[1], v_par[0]])
        v = v + (eps_par * g_par * v_par + eps_perp * g_perp * v_perp) / vsf

        w = w_t[t]  # (3, k)
        share = w[:2] / w[:2].sum(dim=0).clamp(min=1e-12)
        c_mean = (share[0] * r_mean[2] + share[1] * n_mean[t + 1]).sum()
        c_std = share[0] * r_std[2] + share[1] * n_std[t + 1]
        coef = w * c_std / w.sum(dim=0).clamp(min=1e-12)  # (3, k)
        comp = ((coef[0, :, None, None] * ext_new).sum(dim=0)
                + (coef[2, :, None, None] * noise_new).sum(dim=1))
        disp = advance(v, disp, bound)
        comp = sample(comp, disp, bound, fill=0.0)
        field = comp + (coef[1, :, None, None] * nwp_levels[t + 1]).sum(dim=0) + c_mean
        field = torch.where(outside, y[t + 1], field)

        low_f = field.amin(dim=(-2, -1), keepdim=True).clamp(max=low)
        field = low_f + (field - low_f) * mask
        field = torch.where(field > low_f, field, low_f)

        p_radar = float(w[0].sum() / (w[0].sum() + w[1].sum()).clamp(min=1e-12))
        pick = torch.rand((members, m * n), generator=gen, device=gen.device) < p_radar
        target = torch.where(pick, radar_desc, nwp_desc[t])
        field = exact_match(field, target)
        mask = buffered_rain(field >= thr, kr, MASK_RIM)
        out[:, t] = field
    return out


def exact_match(fields, targets):
    """Each member of ``fields`` (B, m, n) given the distribution of its own
    ``targets`` row (B, N): where the target is wetter than the member, its
    values below the member's wet-share quantile become its minimum; pixels
    ranked by value, ties by pixel, take the target value of their rank;
    pixels at the member's minimum take the target's."""
    B = fields.shape[0]
    x = fields.reshape(B, -1)
    size = x.shape[1]
    out = torch.empty_like(x)
    for b in range(B):
        ranked = torch.sort(targets[b]).values
        t_min = ranked[0]
        x_min = x[b].min()
        n_wet = int((x[b] > x_min).sum())
        if int((ranked > t_min).sum()) > n_wet:
            share = n_wet / size
            p = ranked[min(max(round((1.0 - share) * (size - 1)), 0), size - 1)]
            ranked = torch.where(ranked < p, t_min, ranked)
        order = torch.sort(x[b], stable=True).indices
        out[b, order] = ranked
        out[b] = torch.where(x[b] == x_min, t_min, out[b])
    return out.reshape(fields.shape)


def forecast(request, config, seed, device):
    """The reference blend of ``request``'s frames and NWP fields along its
    velocity (host numpy), (E, T, m, n) on ``device``."""
    kw = config["kwargs"]
    return blend(request["frames"], request["nwp"], request["velocity"], int(config["leads"]),
                 int(kw["n_ens_members"]), int(kw["n_cascade_levels"]),
                 float(kw["precip_thr"]), float(config["timestep"]), float(kw["kmperpixel"]),
                 seed, device)
