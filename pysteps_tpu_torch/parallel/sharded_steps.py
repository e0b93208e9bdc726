"""
STEPS with the radar grid partitioned over the mesh (counterpart of
``pysteps_tpu/parallel/sharded_steps.py``): members split over "ens" and
grid rows over "y"; every rank runs the same program on its block.

- **Spectral AR state, column-sharded.**  The cascade and noise state
  live in rfft2 half-planes whose columns are split over "y" (the layout
  of :mod:`pysteps_tpu_torch.parallel.dist_fft`).  The AR update, bandpass
  weighting and noise filtering are pointwise there; the per-level
  statistics are Parseval partial sums and one ``all_reduce``.
- **Shard-count-free draws.**  Each member has its own generator, seeded
  from (seed, member index); every rank draws the member's full
  half-plane with ``noise.fftgenerators._spectral_white`` and keeps its
  columns.  So the result does not depend on the shard counts, as the
  JAX package's per-member keys make it not depend on them.
- **One distributed inverse FFT per lead** (all-to-all pencil transpose,
  ``dist_fft.irfft2_local``) brings the recomposed members back to their
  row blocks for masking, matching and advection.
- **Halo-exchange advection**: the displacement integration samples a
  halo-extended velocity block; one exchange of the matched field's rows
  serves both the rim-mask update and the warp (``ops/warp.warp_shifted``,
  kernel K1 on the card).
- **Sort-free CDF matching**: exact global ranks of the forecast at 128
  value edges from one ``all_reduce`` of local counts, then the
  piecewise-linear quantile map of ``ops/pallas_histmatch.match_cdf_pwl``.

The members of a rank go through each lead as one batch.  On a 1 x 1 x 1
mesh the collectives move nothing and the program is the single-device
one.
"""

import numpy as np
import torch
import torch.distributed as dist

from pysteps_tpu_torch import cascade
from pysteps_tpu_torch.noise.fftgenerators import _spectral_white, nonparam_filter_core
from pysteps_tpu_torch.noise.motion import (
    _laplace,
    get_default_params_bps_par,
    get_default_params_bps_perp,
)
from pysteps_tpu_torch.nowcasts import utils as nowcast_utils
from pysteps_tpu_torch.nowcasts.steps import _estimate_params, _lagrangian_alignment
from pysteps_tpu_torch.ops import pallas_histmatch
from pysteps_tpu_torch.ops.warp import warp_shifted
from pysteps_tpu_torch.parallel.dist_fft import _ceil_to, irfft2_local, spec_weight_local
from pysteps_tpu_torch.parallel.halo import _exchange_halos, _inside, _pad_rows
from pysteps_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_reduce,
    axis_index,
    axis_size,
    member_block,
    mesh_device,
)
from pysteps_tpu_torch.postprocessing.probmatching import _prepare_cdf_target
from pysteps_tpu_torch.utils import tapering

_K = 128  # PWL edges


# the halo exchange along the rows (axis -2), edge shards replicating their
# boundary rows; it gathers the whole column where the halo reaches past a
# neighbour's block
_exchange_rows = _exchange_halos


def _prepare_pwl_target(precip_last):
    """Replicated PWL matching target: the sorted values, their minimum,
    the binned cumulative counts ``c_t[b] = #(bin <= b)`` on the
    (tlo, tscale) grid of ``_B_T`` bins, and the wet count: the layout of
    ``ops/pallas_histmatch.prepare_target``, which builds it."""
    return pallas_histmatch.prepare_target(*_prepare_cdf_target(precip_last))


def _pwl_match_psum(field_rows, zvalue_trg, c_t, tlo, tscale, n_wet_trg, q_max,
                    target_at, size, mesh, axis_name):
    """The distributed PWL match of each member of ``field_rows``
    (..., m_loc, n), ``size`` pixels in all: global edge ranks from one
    ``all_reduce`` of local counts, the target quantile of each edge rank
    from the binned CDF ``c_t`` capped at ``q_max``, the wet-area-ratio
    adjustment with the target value ``target_at(p_idx)`` at the dry
    quantile, then the piecewise-linear map on the local rows."""
    shape = field_rows.shape
    x = field_rows.reshape(-1, shape[-2] * shape[-1])
    lo = all_reduce(x.amin(dim=1), mesh, axis_name, dist.ReduceOp.MIN)
    hi = all_reduce(x.amax(dim=1), mesh, axis_name, dist.ReduceOp.MAX)
    span = torch.clamp(hi - lo, min=1e-12)
    # true divisions, as JAX's: on the card ``tensor / float`` multiplies
    # by a rounded reciprocal, which moves edges by an ulp
    t = torch.arange(_K, dtype=torch.float32, device=x.device) / torch.tensor(
        _K - 1.0, device=x.device)
    edges = lo[:, None] + span[:, None] * t[None, :]

    # k(x) = #(edges <= x); #(x < e_j) = #(k(x) <= j): exact global ranks
    k = torch.searchsorted(edges, x.contiguous(), right=True)
    hist = torch.zeros((x.shape[0], _K + 1), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, k, torch.ones_like(k))
    r = all_reduce(torch.cumsum(hist[:, :_K], dim=1), mesh, axis_name)
    v = torch.searchsorted(c_t, r.to(c_t.dtype), right=True)
    q = torch.minimum(tlo + (v.to(torch.float32) + 0.5) / tscale, q_max)

    # wet-area-ratio adjustment (reference: probmatching.py:106-112)
    n_wet_init = all_reduce((x > lo[:, None]).sum(dim=1), mesh, axis_name)
    war = n_wet_init.to(torch.float32) / torch.tensor(size, device=x.device)
    p_idx = torch.clamp(
        torch.round((1.0 - war) * (size - 1.0)).to(torch.int64), 0, int(size) - 1
    )
    p = target_at(p_idx)
    adjust = (n_wet_trg > n_wet_init)[:, None] & (q < p[:, None])
    q = torch.where(adjust, zvalue_trg, q)
    q = torch.cummax(q, dim=1).values

    de = edges[:, 1:] - edges[:, :-1]
    tiny = (span * 1e-7)[:, None]
    slope = torch.cat(
        [torch.where(de > tiny, (q[:, 1:] - q[:, :-1]) / torch.maximum(de, tiny), 0.0),
         torch.zeros_like(q[:, :1])], dim=1,
    )
    c0 = torch.cat([q[:, :-1] - slope[:, :-1] * edges[:, :-1], q[:, -1:]], dim=1)
    # x >= lo = e_0, so k >= 1: the segment of x is k - 1
    seg = k - 1
    out = torch.gather(c0, 1, seg) + x * torch.gather(slope, 1, seg)
    out = torch.where(x == lo[:, None], zvalue_trg, out)
    return out.reshape(shape)


def _match_cdf_psum(field_rows, tstate, size, mesh, axis_name="y"):
    """Distributed CDF match of the row-sharded members (..., m_loc, n)
    against the replicated target ``tstate`` (:func:`_prepare_pwl_target`)."""
    ranked, zvalue_trg, c_t, tlo, tscale, n_wet_trg = tstate
    return _pwl_match_psum(
        field_rows, zvalue_trg, c_t, tlo, tscale, n_wet_trg, ranked[-1],
        lambda p_idx: ranked[p_idx], size, mesh, axis_name,
    )


def _match_cdf_psum_binned(field_rows, zvalue_trg, c_t, tlo, tscale, n_wet_trg,
                           trg_max, size, mesh, axis_name="y"):
    """:func:`_match_cdf_psum` on a purely binned target: the cap and the
    dry-quantile value come from the binned CDF ``c_t``, so no sorted
    target is needed (sharded blending's resampled targets change every
    lead).  ``c_t`` is one target (bins,) for every member, or one a
    member (B, bins) with (B,) statistics ``zvalue_trg``, ``tlo``,
    ``tscale``, ``n_wet_trg`` and ``trg_max``."""
    if c_t.ndim == 2:
        def target_at_each(p_idx):
            vp = torch.searchsorted(c_t, p_idx.to(c_t.dtype)[:, None], right=True)[:, 0]
            return torch.minimum(tlo + (vp.to(torch.float32) + 0.5) / tscale, trg_max)

        return _pwl_match_psum(
            field_rows, zvalue_trg[:, None], c_t, tlo[:, None], tscale[:, None], n_wet_trg,
            trg_max[:, None], target_at_each, size, mesh, axis_name,
        )

    def target_at(p_idx):
        vp = torch.searchsorted(c_t, p_idx.to(c_t.dtype), right=True)
        return torch.minimum(tlo + (vp.to(torch.float32) + 0.5) / tscale, trg_max)

    return _pwl_match_psum(
        field_rows, zvalue_trg, c_t, tlo, tscale, n_wet_trg, trg_max, target_at,
        size, mesh, axis_name,
    )


def _dilated_mask_from_ext(ext, halo, thr, kr, r, mesh, axis_name="y"):
    """Incremental-mask update of (B, m_loc + 2 halo, n) halo-extended
    members (halo >= kr + r): the serial rim build on the block, cut to
    the rank's rows and divided by each member's global maximum.  Sharing
    the warp's exchange saves one collective round a lead."""
    mask_d = nowcast_utils.binary_dilation(ext >= thr, kr)
    mask = mask_d.to(torch.float32)
    for _ in range(int(r)):
        mask_d = nowcast_utils._cross_dilate(mask_d.to(torch.float32)) > 0
        mask = mask + mask_d
    mask = mask[..., halo:-halo, :]
    gmax = all_reduce(mask.amax(dim=(-2, -1)), mesh, axis_name, dist.ReduceOp.MAX)
    return mask / torch.clamp(gmax, min=1.0)[:, None, None]


def _dilated_mask_halo(field_rows, thr, kr, r, mesh, axis_name="y"):
    """Incremental-mask update of row-sharded members with its own halo
    exchange of kr + r rows (the forecast's loop shares the warp's
    exchange instead: :func:`_dilated_mask_from_ext`)."""
    halo = int(kr + r)
    ext = _exchange_rows(field_rows, halo, mesh, axis_name)
    return _dilated_mask_from_ext(ext, halo, thr, kr, r, mesh, axis_name)


def _sample_velocity_ext(vel_ext, disp, halo):
    """Edge-clamped bilinear sample of the halo-extended velocity
    (B or 1, 2, m_loc + 2 halo, n) at each member's displaced positions
    (B, 2, m_loc, n); |displacement| <= halo keeps them in the block."""
    B, _, m_loc, n = disp.shape
    M = vel_ext.shape[-2]
    yy = torch.arange(m_loc, dtype=disp.dtype, device=disp.device)[:, None]
    xx = torch.arange(n, dtype=disp.dtype, device=disp.device)[None, :]
    cy = yy + disp[:, 1] + halo
    cx = xx + disp[:, 0]
    y0, x0 = torch.floor(cy), torch.floor(cx)
    wy, wx = (cy - y0)[:, None], (cx - x0)[:, None]
    y0i, x0i = y0.long(), x0.long()
    flat = vel_ext.expand(B, 2, M, n).reshape(B, 2, M * n)

    def gather(yi, xi):
        idx = torch.clamp(yi, 0, M - 1) * n + torch.clamp(xi, 0, n - 1)
        idx = idx.reshape(B, 1, m_loc * n).expand(B, 2, m_loc * n)
        return torch.gather(flat, 2, idx).reshape(B, 2, m_loc, n)

    top = gather(y0i, x0i) * (1.0 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1.0 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1.0 - wy) + bot * wy


def _warp_from_ext(ext, disp, halo, precip_min, mesh, axis_name="y"):
    """Backward warp of halo-extended members (B, m_loc + 2 halo, n) by
    their displacement (B, 2, m_loc, n) through ``warp_shifted`` (K1 on the
    card); ``precip_min`` outside the global domain."""
    out = warp_shifted(ext, _pad_rows(disp, halo), halo, mode="nearest")
    out = out[..., halo:-halo, :]
    m_loc = disp.shape[-2]
    row0 = axis_index(mesh, axis_name) * m_loc
    inside = _inside(disp, row0, axis_size(mesh, axis_name) * m_loc)
    return torch.where(inside, out, precip_min)


def _member_seed(seed, j):
    """The seed of member ``j``'s generator: a function of (seed, j) only."""
    return int(np.random.SeedSequence([int(seed), int(j)]).generate_state(1)[0])


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def forecast(
    precip,
    velocity,
    timesteps,
    mesh,
    n_ens_members=8,
    n_cascade_levels=6,
    precip_thr=None,
    kmperpixel=None,
    timestep=None,
    mask_kwargs=None,
    seed=None,
    vel_pert_method=None,
    vel_pert_kwargs=None,
):
    """Spatially sharded STEPS ensemble forecast.

    Every rank of ``mesh`` calls it with the same global inputs; members
    split over "ens" and grid rows over "y".  Fixed configuration (the
    STEPS defaults): nonparametric noise, AR(2), the incremental mask and
    CDF matching; optional BPS velocity perturbation
    (``vel_pert_method="bps"``).  Returns the global (E, T, m, n) tensor on
    every rank, on the rank's device (its card on an NCCL mesh)."""
    precip = _host(precip).astype(np.float32)[-3:]
    velocity = _host(velocity).astype(np.float32)
    m, n = precip.shape[1:]
    ens_shards = axis_size(mesh, "ens")
    y_shards = axis_size(mesh, "y")
    if m % y_shards:
        raise ValueError(f"rows {m} not divisible by y shards {y_shards}")
    if n_ens_members % ens_shards:
        raise ValueError(
            f"members {n_ens_members} not divisible by ens shards {ens_shards}"
        )
    if precip_thr is None:
        raise ValueError("precip_thr required")
    int_steps = int(timesteps)
    mask_kwargs = dict(mask_kwargs or {})
    seed = seed if seed is not None else 42
    dev = mesh_device(mesh)
    E = n_ens_members

    precip_min = float(np.nanmin(precip))
    precip = np.where(np.isfinite(precip), precip, precip_min)
    velocity_t = torch.as_tensor(velocity, device=dev)
    precip_t = torch.as_tensor(precip, device=dev)

    # ---- replicated init: alignment, AR fit, noise filter, mask, target
    precip_aligned = _lagrangian_alignment(precip_t, velocity_t)
    bp_filter = cascade.get_method("gaussian")((m, n), n_cascade_levels)
    weights_2d = torch.tensor(bp_filter["weights_2d"], dtype=torch.float32, device=dev)
    mask_thr = torch.ones((m, n), dtype=torch.bool, device=dev)
    cascades_full, means, stds, _, phi = _estimate_params(
        precip_aligned, weights_2d, mask_thr, 2, False
    )
    taper = torch.as_tensor(
        tapering.compute_window_function(m, n, "tukey"), dtype=torch.float32, device=dev
    )
    noise_filt = nonparam_filter_core(precip_aligned, taper).to(torch.float32)
    window_fft = torch.fft.rfft2(cascades_full[:, -2:])  # (k, 2, m, c)

    mask_rim = int(mask_kwargs.get("mask_rim", 10))
    struct_radius = 1
    if timestep is not None and kmperpixel:
        struct_radius = max(
            int((mask_kwargs.get("mask_f", 1.0) * timestep / kmperpixel - 1) / 2.0), 1
        )
    mask0 = nowcast_utils.compute_dilated_mask(
        (precip_t[-1] >= precip_thr)[None], struct_radius, mask_rim
    )[0].to(torch.float32)
    tstate = _prepare_pwl_target(precip_t[-1])

    # ---- this rank's spectral columns (padded to split evenly), rows
    # and members
    c = n // 2 + 1
    c_pad = _ceil_to(c, y_shards)
    c_loc = c_pad // y_shards
    col0 = axis_index(mesh, "y") * c_loc
    m_loc = m // y_shards
    row0 = axis_index(mesh, "y") * m_loc
    e0, e1 = member_block(E, mesh)

    def cols(a):
        a = torch.cat([a, a.new_zeros(a.shape[:-1] + (c_pad - c,))], dim=-1)
        return a[..., col0 : col0 + c_loc]

    w2d_l = cols(weights_2d)              # (k, m, c_loc)
    filt_l = cols(noise_filt)             # (m, c_loc)
    winf_l = cols(window_fft)             # (k, 2, m, c_loc)
    herm_l = spec_weight_local(n, y_shards, mesh)

    # BPS velocity perturbations (reference: noise/motion.py; the static-
    # flow form of nowcasts/steps.py: per-member Laplace draws scale
    # time-growing parallel / perpendicular unit fields)
    vel_pert = vel_pert_method is not None
    timestep_min = float(timestep) if timestep else 1.0
    if vel_pert:
        vpk = dict(vel_pert_kwargs or {})
        p_par = tuple(float(v) for v in vpk.get("p_par", get_default_params_bps_par()))
        p_perp = tuple(float(v) for v in vpk.get("p_perp", get_default_params_bps_perp()))
        vsf = 60.0 / (timestep * (1.0 / kmperpixel)) if (timestep and kmperpixel) else 1.0
        vgen = torch.Generator(device=dev)
        vgen.manual_seed(seed + 7)
        eps_par = _laplace(vgen, (E,))
        eps_perp = _laplace(vgen, (E,))
        nv = torch.linalg.vector_norm(velocity_t, dim=0)
        V_n = torch.where(nv[None] > 1e-12, velocity_t / torch.clamp(nv[None], min=1e-12), 0.0)
        V_perp = torch.stack([-V_n[1], V_n[0]])
        t_last = int_steps * timestep_min
        g_par_l = abs(p_par[0] * t_last ** p_par[1] + p_par[2])
        g_perp_l = abs(p_perp[0] * t_last ** p_perp[1] + p_perp[2])
        pert_margin = 4.0 * max(g_par_l, g_perp_l) / max(vsf, 1e-6)
    else:
        pert_margin = 0.0

    vmax = float(np.max(np.abs(velocity))) if velocity.size else 0.0
    # the advection's reach, even where it passes the block's height (the
    # exchange then gathers the column), capped at the grid's height, past
    # which edge clamping makes any further reach a no-op; the rim mask's
    # kr + r whole, so that one exchange a lead serves both
    reach = int(np.ceil(int_steps * (vmax + pert_margin + 0.5))) + 2
    halo = max(min(reach, m), struct_radius + mask_rim, 2)
    size_f = float(m * n)
    mlast, slast = means[-1], stds[-1]

    def rows_ext(v):
        return _exchange_rows(v[..., row0 : row0 + m_loc, :], halo, mesh)

    vel_ext = rows_ext(velocity_t)[None]  # (1, 2, m_loc + 2 halo, n)
    if vel_pert:
        vn_ext, vperp_ext = rows_ext(V_n)[None], rows_ext(V_perp)[None]
        epar_l = eps_par[e0:e1, None, None, None]
        eperp_l = eps_perp[e0:e1, None, None, None]

    E_loc = e1 - e0
    lags = tuple(winf_l[:, i].expand((E_loc,) + winf_l[:, i].shape) for i in range(2))
    mask_prec = mask0[row0 : row0 + m_loc].expand(E_loc, m_loc, n)
    disp = torch.zeros((E_loc, 2, m_loc, n), dtype=torch.float32, device=dev)
    gens = []
    for j in range(e0, e1):
        g = torch.Generator(device=dev)
        g.manual_seed(_member_seed(seed, j))
        gens.append(g)
    out = torch.empty((E_loc, int_steps, m_loc, n), dtype=torch.float32, device=dev)

    for t in range(int_steps):
        t_total = np.float32((t + 1.0) * timestep_min)
        # each member's full half-plane draw, this rank's columns
        white = cols(torch.cat([_spectral_white(g, (m, n), 1) for g in gens]))
        lv = white[:, None] * filt_l * w2d_l  # (E_loc, k, m, c_loc)
        # per-level spectral moments: Parseval partial sums, one all_reduce
        pw = lv.real**2 + lv.imag**2
        s2 = torch.sum(pw * herm_l, dim=(-2, -1))
        dc = lv[..., 0, 0].real if col0 == 0 else torch.zeros_like(s2)
        s2, dc = all_reduce(torch.stack([s2, dc]), mesh, "y")
        mu = dc / size_f
        sd = torch.sqrt(torch.clamp(s2 / size_f**2 - mu**2, min=1e-24))
        # normalize: subtract the mean from the DC bin, unit spectral std
        if col0 == 0:
            lv = lv.clone()
            lv[..., 0, 0] = lv[..., 0, 0] - mu * size_f
        eps = lv / sd[..., None, None]
        # AR(2) step (nowcasts/steps.py:_ar_step_lags)
        x_new = (
            lags[1] * phi[:, 0, None, None]
            + lags[0] * phi[:, 1, None, None]
            + phi[:, 2, None, None] * eps
        )
        lags = (lags[1], x_new)
        # spectral recomposition and the distributed inverse FFT
        out_fft = torch.sum(x_new * slast[:, None, None], dim=-3)
        if col0 == 0:
            out_fft[..., 0, 0] = out_fft[..., 0, 0] + torch.sum(mlast) * size_f
        field = irfft2_local(out_fft, (m, n), mesh)  # (E_loc, m_loc, n)

        fmin = all_reduce(field.amin(dim=(-2, -1)), mesh, "y", dist.ReduceOp.MIN)[:, None, None]
        field = fmin + (field - fmin) * mask_prec
        field = _match_cdf_psum(field, tstate, size_f, mesh)
        # one exchange of the matched field's rows serves the rim mask and
        # the warp (halo >= kr + r)
        ext = _exchange_rows(field, halo, mesh)
        mask_prec = _dilated_mask_from_ext(ext, halo, precip_thr, struct_radius, mask_rim, mesh)
        # advect: integrate the displacement on the halo-extended velocity
        # (BPS-perturbed per member), warp with the halo
        if vel_pert:
            a1, b1, c1 = (np.float32(v) for v in p_par)
            a2, b2, c2 = (np.float32(v) for v in p_perp)
            g_par = float(a1 * t_total**b1 + c1)
            g_perp = float(a2 * t_total**b2 + c2)
            vel_ext_j = vel_ext + (
                epar_l * g_par * vn_ext + eperp_l * g_perp * vperp_ext
            ) / vsf
        else:
            vel_ext_j = vel_ext
        vel_inc = _sample_velocity_ext(vel_ext_j, disp, halo)
        vel_inc = _sample_velocity_ext(vel_ext_j, disp - vel_inc / 2.0, halo)
        disp = disp - vel_inc
        out[:, t] = _warp_from_ext(ext, disp, halo, precip_min, mesh)

    out = all_gather_cat(out, mesh, "y", dim=-2)
    return all_gather_cat(out, mesh, "ens", dim=0)
