"""
STEPS x NWP blending with the radar grid partitioned over the mesh
(counterpart of ``pysteps_tpu/parallel/sharded_blending.py``): the
blended member update of ``blending/steps.py::_blending_scan`` with
members split over "ens" and grid rows over "y"; every rank runs the same
program on its block.

- **Spatial cascades, row-sharded.**  Both Lagrangian cascades
  (extrapolation and noise) stay in the spatial domain, as in the
  unsharded loop: every level is advected each lead and blended pointwise
  with the row-sharded NWP cascades, so row blocks are the natural layout.
  The extrapolation cascade evolves without noise and is kept once, for
  every member.
- **The unsharded loop's draws.**  Every rank makes the draws of the
  unsharded loop from the forecast's one generator, in its order (each
  lead the white half-planes of all members, then, with a resampled CDF
  target, all members' picks), and keeps its members and its spectral
  columns.  So the result does not depend on the shard counts and equals
  the unsharded blend up to rounding.  The draws go through the module's
  ``_fft_noise_draw`` and ``_bernoulli``, which a test may replace.
- **Sharded noise.**  The nonparametric filter and the bandpass weights
  apply pointwise to the rank's columns; each level's mean and standard
  deviation come from Parseval partial sums and one ``all_reduce`` (the
  spatial moments of the unsharded decomposition, by linearity); k
  distributed inverse FFTs return the levels to the rank's rows.
- **Halo-exchange advection.**  The blend weights are scalars a level and
  the warp is linear, so the advected levels enter as one pre-weighted
  composite a member: one exchange of its rows and one warp through
  ``ops/warp.warp_shifted`` (kernel K1 on the card), the velocity (a
  model's, BPS-perturbed on the halo-extended block) sampled by the
  midpoint rule on its own exchange.
- **psum CDF matching** against the replicated radar target, or against
  the resampled target: the radar and NWP intensity sorts and their
  static per-bin rank indices are prepared on the host, and each lead the
  picks become each member's binned target CDF by suffix sums.

Supported, as in the JAX package: the internal nowcast (no external
ensemble), ``probmatching_method`` "cdf" (with or without the resampled
target), "mean" or None, ``mask_method`` "incremental", "obs" or None,
BPS velocity perturbations and any number of NWP models.  On a 1 x 1 x 1
mesh, or with ``mesh=None`` (one block without a process group), the
program is the single-device one.
"""

import numpy as np
import torch
import torch.distributed as dist

from pysteps_tpu_torch.blending.steps import blend_means_sigmas
from pysteps_tpu_torch.noise.fftgenerators import _fft_noise_draw
from pysteps_tpu_torch.nowcasts.steps import _ar_step_lags
from pysteps_tpu_torch.ops.pallas_histmatch import B_T
from pysteps_tpu_torch.parallel.dist_fft import _ceil_to, irfft2_local, spec_weight_local
from pysteps_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_reduce,
    axis_index,
    axis_size,
    member_block,
)
from pysteps_tpu_torch.parallel.sharded_steps import (
    _dilated_mask_halo,
    _exchange_rows,
    _match_cdf_psum,
    _match_cdf_psum_binned,
    _prepare_pwl_target,
    _sample_velocity_ext,
    _warp_from_ext,
)
from pysteps_tpu_torch.postprocessing.probmatching import _bernoulli


def _halo(int_steps, vmax_bound, struct_radius, mask_rim, m):
    """Rows a rank exchanges: the displacement's reach over the forecast,
    at least the rim mask's, capped at the grid's height (past which edge
    clamping makes further reach a no-op), never at the block's (the
    exchange gathers the column where the halo passes a neighbour)."""
    reach = int(np.ceil(int_steps * (vmax_bound + 0.5))) + 2
    return min(max(reach, struct_radius + mask_rim, 2), m)


def _resample_tables(precip_last, nwp_fields, precip_min):
    """The resampled target's static tables, on the host as in the JAX
    package: the descending radar sort (N,), the descending NWP sorts
    (T, n_models, N), and for each (lead, model) on a grid of ``B_T``
    bins over both ranges the first descending rank whose value falls at
    or below each bin (``idx_r``, ``idx_n``, (T, n_models, B_T)), with the
    grid's float32 origin ``tlo`` and scale ``tscale`` (T, n_models)."""
    pl = np.asarray(precip_last, np.float32).ravel()
    pl = np.where(np.isnan(pl), np.nanmin(pl), pl)
    rsort = np.sort(pl)[::-1]
    T_n, nm = nwp_fields.shape[:2]
    N = pl.size
    nf = np.asarray(nwp_fields, np.float32).reshape(T_n, nm, N)
    nf = np.where(np.isnan(nf), precip_min, nf)
    nsort = -np.sort(-nf, axis=-1)
    tlo = np.minimum(rsort[-1], nsort[:, :, -1])
    thi = np.maximum(rsort[0], nsort[:, :, 0])
    tscale = (B_T - 1.0) / np.maximum(thi - tlo, 1e-12)
    idx_r = np.empty((T_n, nm, B_T), np.int64)
    idx_n = np.empty((T_n, nm, B_T), np.int64)
    bgrid = np.arange(B_T)
    for t in range(T_n):
        for mod in range(nm):
            sc, lo = tscale[t, mod], tlo[t, mod]
            tr = np.clip(np.round((rsort - lo) * sc), 0, B_T - 1)
            tn = np.clip(np.round((nsort[t, mod] - lo) * sc), 0, B_T - 1)
            idx_r[t, mod] = N - np.searchsorted(tr[::-1], bgrid, side="right")
            idx_n[t, mod] = N - np.searchsorted(tn[::-1], bgrid, side="right")
    return rsort, nsort, idx_r, idx_n, tlo.astype(np.float32), tscale.astype(np.float32)


def _binned_targets(pick, rsort, nsort, idx_r, idx_n):
    """Each member's resampled target from its picks (B, N) (True: the
    radar's value at that descending rank, else the NWP's): its minimum,
    maximum and wet count, and its binned CDF (B, B_T), the picked radar
    values and the unpicked NWP values at or below each bin, counted by
    suffix sums of the picks at the static rank indices."""
    B, N = pick.shape
    mixed = torch.where(pick, rsort, nsort)
    zv = mixed.amin(dim=1)
    trg_max = mixed.amax(dim=1)
    n_wet = (mixed > zv[:, None]).sum(dim=1)
    cum = torch.cumsum(pick, dim=1, dtype=torch.int32)
    total = cum[:, -1:]
    zero = torch.zeros((B, 1), dtype=torch.int32, device=pick.device)
    s_r = total - torch.cat([zero, cum], dim=1)
    ranks = torch.arange(1, N + 1, dtype=torch.int32, device=pick.device)
    s_n = (N - total) - torch.cat([zero, ranks - cum], dim=1)
    c_mix = torch.gather(s_r, 1, idx_r) + torch.gather(s_n, 1, idx_n)
    return zv, trg_max, n_wet, c_mix


def _noise_levels(white_l, filt_l, w2d_l, herm_l, nsc, shape, col0, mesh):
    """The normalized noise levels of (B, m, c_loc) white spectral columns
    starting at column ``col0``: filtered, split by the bandpass weights
    ``w2d_l`` (k, m, c_loc), each level's spatial mean (DC / size) and
    standard deviation from Parseval partial sums (columns weighted by
    ``herm_l``) and one ``all_reduce`` over "y", the mean taken out of the
    DC bin, scaled by ``nsc`` / std and inverted by k distributed FFTs.
    Returns (levels (B, k, m_loc, n), means (B, k), stds (B, k))."""
    size_f = float(shape[0] * shape[1])
    lv = white_l[:, None] * filt_l * w2d_l  # (B, k, m, c_loc)
    s2 = torch.sum((lv.real**2 + lv.imag**2) * herm_l, dim=(-2, -1))
    dc = lv[..., 0, 0].real if col0 == 0 else torch.zeros_like(s2)
    s2, dc = all_reduce(torch.stack([s2, dc]), mesh, "y")
    mu = dc / size_f
    sd = torch.sqrt(torch.clamp(s2 / size_f**2 - mu**2, min=0.0))
    if col0 == 0:
        lv = lv.clone()
        lv[..., 0, 0] = lv[..., 0, 0] - mu * size_f
    lv = lv * (nsc / torch.clamp(sd, min=1e-12))[..., None, None]
    return irfft2_local(lv, shape, mesh), mu, sd


def blending_scan_sharded(
    params, state, int_steps, mesh, mask_method, probmatching_method, resample_distribution,
    mask_rim, struct_radius, precip_thr, max_disp=None, vel_pert=False, p_par=None,
    p_perp=None, vsf=1.0, timestep_min=1.0, use_noise=True, vmax_bound=None, members=None,
    callback=None,
):
    """Spatially sharded blended forecast loop: ``_blending_scan``'s
    arguments (``params``, ``state`` and the statics that
    ``blending/steps.py::forecast`` prepares) on an ("ens", "y") mesh.

    Every rank of ``mesh`` calls it with the same global inputs.
    ``vmax_bound`` (the blended velocity's largest speed plus the BPS
    margin; from the velocity when None) sizes the halo; ``max_disp`` is
    the unsharded loop's and unused here.  Returns the member-major
    (E, T, m, n) result on every rank.  Raises ``ValueError`` for an
    external nowcast, for a chunked loop (``members`` or a streaming
    ``callback``), and where "y" does not divide the rows or "ens" the
    members."""
    if params.ext_cascades is not None:
        raise ValueError("sharded blending: external nowcast not supported")
    if members is not None or callback is not None:
        raise ValueError("sharded blending: chunked scan not supported")
    k_levels, p, m, n = state.cascades.shape
    E = params.member_model.shape[0]
    ens_shards = axis_size(mesh, "ens")
    y_shards = axis_size(mesh, "y")
    if m % y_shards:
        raise ValueError(f"rows {m} not divisible by y shards {y_shards}")
    if E % ens_shards:
        raise ValueError(f"members {E} not divisible by ens shards {ens_shards}")
    int_steps = int(int_steps)
    dev = state.cascades.device
    gen = state.generator
    phi = params.phi
    nm = params.weights.shape[1]
    N = m * n
    size_f = float(N)
    m_loc = m // y_shards
    row0 = axis_index(mesh, "y") * m_loc
    e0, e1 = member_block(E, mesh)
    E_loc = e1 - e0
    c = n // 2 + 1
    c_pad = _ceil_to(c, y_shards)
    c_loc = c_pad // y_shards
    col0 = axis_index(mesh, "y") * c_loc

    if vmax_bound is None:
        vmax_bound = float(params.velocity_blend.abs().max())
    halo = _halo(int_steps, vmax_bound, struct_radius, mask_rim, m)

    def rows(a):
        return a[..., row0 : row0 + m_loc, :]

    def cols(a):
        a = torch.cat([a, a.new_zeros(a.shape[:-1] + (c_pad - c,))], dim=-1)
        return a[..., col0 : col0 + c_loc]

    filt = params.noise_filter
    if filt.shape[-1] == n and n != c:  # a full-plane Hermitian amplitude filter
        filt = filt[..., :c]
    filt_l = cols(filt.to(torch.float32))          # (m, c_loc)
    w2d_l = cols(params.weights_2d)                # (k, m, c_loc)
    herm_l = spec_weight_local(n, y_shards, mesh).to(dev)
    nsc = params.noise_std_coeffs

    mm_all = params.member_model
    mm = mm_all[e0:e1]
    ext_lags = tuple(rows(state.cascades[:, i]) for i in range(p))
    if use_noise:
        if state.noise_cascades is None:
            noise_lags = tuple(torch.zeros((E_loc, k_levels, m_loc, n), device=dev)
                               for _ in range(p))
        else:
            noise_lags = tuple(rows(state.noise_cascades[e0:e1, :, i]) for i in range(p))
    mask = rows(state.precip_mask).expand(E_loc, m_loc, n)
    disp = torch.zeros((E_loc, 2, m_loc, n), dtype=torch.float32, device=dev)
    vel_l = rows(params.velocity_blend)            # (T, nm, 2, m_loc, n)
    nwpc_l = rows(params.nwp_cascades)             # (T, nm, k, m_loc, n)
    nwpf_l = rows(params.nwp_fields)               # (T, nm, m_loc, n)
    dmask_l = rows(params.domain_mask)
    smask_l = rows(params.smooth_mask)
    if vel_pert:
        eps_par = state.eps_par[e0:e1, None, None, None]
        eps_perp = state.eps_perp[e0:e1, None, None, None]

    resample = probmatching_method == "cdf" and bool(resample_distribution)
    if resample:
        tables = _resample_tables(params.precip_last.cpu().numpy(),
                                  params.nwp_fields.cpu().numpy(), float(params.precip_min))
        rsort, nsorted, idx_r, idx_n, tlo_tm, tscale_tm = (
            torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in tables)
    elif probmatching_method == "cdf":
        tstate = _prepare_pwl_target(params.precip_last)
    elif probmatching_method == "mean":
        wet_obs = params.precip_last >= precip_thr
        mu_obs = torch.where(wet_obs, params.precip_last, 0.0).sum() / torch.clamp(
            wet_obs.sum(), min=1)

    out = torch.empty((E_loc, int_steps, m_loc, n), dtype=torch.float32, device=dev)
    rows_e = torch.arange(E_loc, device=dev)
    for t in range(int_steps):
        ext_lags = _ar_step_lags(ext_lags, phi)
        if use_noise:
            # every member's white half-plane, this rank's members and columns
            white = cols(_fft_noise_draw(gen, (m, n), E, "spatial", False)[e0:e1])
            eps_levels = _noise_levels(white, filt_l, w2d_l, herm_l, nsc, (m, n), col0, mesh)[0]
            del white
            noise_lags = _ar_step_lags(noise_lags, phi, eps=eps_levels)

        # blend weights and recomposition coefficients (E_loc, k)
        w = params.weights[t].index_select(0, mm)  # (E_loc, 3, k)
        wsum = torch.clamp(w.sum(dim=1), min=1e-12)
        means = torch.stack([params.radar_means.expand(E_loc, k_levels),
                             params.nwp_means[t].index_select(0, mm)])
        sigmas = torch.stack([params.radar_sigmas.expand(E_loc, k_levels),
                              params.nwp_sigmas[t].index_select(0, mm)])
        c_means, c_sigmas = blend_means_sigmas(means, sigmas, w.transpose(0, 1))
        a_ext = w[:, 0] * c_sigmas / wsum
        a_nwp = w[:, 1] * c_sigmas / wsum
        a_noi = w[:, 2] * c_sigmas / wsum
        comp = torch.einsum("ek,kmn->emn", a_ext, ext_lags[-1])
        if use_noise:
            comp = comp + torch.einsum("ekmn,ek->emn", noise_lags[-1], a_noi)

        # the member's model velocity on its halo-extended rows,
        # BPS-perturbed along its direction, by the midpoint rule
        vel_ext = _exchange_rows(vel_l[t], halo, mesh)  # (nm, 2, m_loc + 2 halo, n)
        vel_ext = vel_ext if nm == 1 else vel_ext.index_select(0, mm)
        if vel_pert:
            t_total = np.float32((t + 1.0) * timestep_min)
            a1, b1, c1 = (np.float32(v) for v in p_par)
            a2, b2, c2 = (np.float32(v) for v in p_perp)
            g_par = float(a1 * t_total**b1 + c1)
            g_perp = float(a2 * t_total**b2 + c2)
            nv = torch.linalg.vector_norm(vel_ext, dim=1, keepdim=True)
            v_n = torch.where(nv > 1e-12, vel_ext / torch.clamp(nv, min=1e-12), 0.0)
            v_perp = torch.stack([-v_n[:, 1], v_n[:, 0]], dim=1)
            vel_ext = vel_ext + (eps_par * g_par * v_n + eps_perp * g_perp * v_perp) / vsf
        vel_inc = _sample_velocity_ext(vel_ext, disp, halo)
        vel_inc = _sample_velocity_ext(vel_ext, disp - vel_inc / 2.0, halo)
        disp = disp - vel_inc
        del vel_ext, vel_inc
        comp = _warp_from_ext(_exchange_rows(comp, halo, mesh), disp, halo, 0.0, mesh)

        a_models = torch.zeros((E_loc, nm, k_levels), dtype=torch.float32, device=dev)
        a_models[rows_e, mm] = a_nwp
        field = comp + torch.einsum("ejk,jkmn->emn", a_models, nwpc_l[t])
        field = field + c_means.sum(dim=1)[:, None, None]

        # NWP outside the radar domain, smooth transition at its edge
        nwp_field = nwpf_l[t].index_select(0, mm)
        field = torch.where(dmask_l, nwp_field, field)
        field = smask_l * field + (1.0 - smask_l) * nwp_field

        fmin = all_reduce(field.amin(dim=(-2, -1)), mesh, "y", dist.ReduceOp.MIN)
        fmin = torch.minimum(fmin, params.precip_min)[:, None, None]
        if mask_method == "incremental":
            field = fmin + (field - fmin) * mask
            field = torch.where(field > fmin, field, fmin)
        elif mask_method == "obs":
            field = torch.where(mask > 0, field, fmin)

        if probmatching_method == "cdf":
            if resample:
                # the picks of every member, weighted by its extrapolation
                # skill; this rank's members' binned targets
                w_all = params.weights[t].index_select(0, mm_all)
                s0, s1 = w_all[:, 0].sum(dim=1), w_all[:, 1].sum(dim=1)
                p_radar = s0 / torch.clamp(s0 + s1, min=1e-12)
                pick = _bernoulli(gen, p_radar[:, None], (E, N))[e0:e1]
                zv, trg_max, n_wet, c_mix = _binned_targets(
                    pick, rsort, nsorted[t].index_select(0, mm),
                    idx_r[t].index_select(0, mm), idx_n[t].index_select(0, mm))
                del pick
                field = _match_cdf_psum_binned(
                    field, zv, c_mix, tlo_tm[t].index_select(0, mm),
                    tscale_tm[t].index_select(0, mm), n_wet, trg_max, size_f, mesh)
            else:
                field = _match_cdf_psum(field, tstate, size_f, mesh)
        elif probmatching_method == "mean":
            wet = field >= precip_thr
            num = all_reduce(torch.where(wet, field, 0.0).sum(dim=(-2, -1)), mesh, "y")
            den = all_reduce(wet.sum(dim=(-2, -1)), mesh, "y")
            mu_fct = (num / torch.clamp(den, min=1))[:, None, None]
            field = torch.where(wet, field - mu_fct + mu_obs, field)

        if mask_method == "incremental":
            mask = _dilated_mask_halo(field, precip_thr, struct_radius, mask_rim, mesh)
        out[:, t] = field

    out = all_gather_cat(out, mesh, "y", dim=-2)
    return all_gather_cat(out, mesh, "ens", dim=0)
