"""
STEPS blending of a radar nowcast with NWP on PyTorch (counterpart of
``pysteps_tpu/blending/steps.py``; Imhoff et al. 2023).

The JAX package's design carries over:

- the per-lead weights (NWP skill regressed towards climatology,
  extrapolation skill through the AR decay) and the blended advection
  fields do not depend on the ensemble state, so they are computed once
  before the loop: the weights on the host, where only the lag-0
  correlations ``rho_0`` come back from the device for them, and the
  advection on the device from the weights.  The inputs cross to the
  device once and are gated, filled and blended there (the JAX package
  does this on the host);
- the loop advances every member at once (JAX vmaps over members) in a
  Python loop over leads (JAX: ``lax.scan``).  A member's NWP model is a
  gather along the member axis; the NWP cascades enter the recomposition
  as one contraction per lead and are never copied per member.  The
  extrapolation cascade evolves without noise, so it is the same for every
  member: the loop keeps one copy (the JAX package one per member);
- the per-level blend weights are scalars and the warp is linear, so all
  that needs advecting is summed into one composite field a member and
  warped once.

On a CUDA device the loop takes the path the JAX package takes on the
TPU: a static displacement bound ``max_disp`` from the blended velocity,
the displacement carried on the 4x coarse grid through kernel K1
(``ops/pallas_warp.py``), the composite warped by K1's shift
decomposition, and the incremental mask's rim from kernel K4
(``ops/pallas_dilate.py``).  On the CPU it takes the JAX package's CPU
path, the exact bilinear gather, unless ``extrap_kwargs["max_disp"]``
sets the bound.  Randomness (the noise, the Bernoulli pick of the
resampled CDF target, the BPS draws) comes from ``torch.Generator``s
seeded from ``seed``; the draws differ from the JAX package's, their law
does not.

``member_chunk`` (a divisor of the member count) runs the whole loop one
chunk of members at a time into one output buffer, so that only a chunk's
state is live.  Unlike the JAX package, the port chunks whenever
``member_chunk`` divides the member count: the JAX package's size
threshold (``PYSTEPS_TPU_OUTER_CHUNK_BYTES``, 12.5 GB) sizes the state
against a TPU v5e's 16 GB of HBM and is not carried over.

``mesh`` routes as in the JAX package: members over "ens" (every rank
makes every member's draws and keeps its block's), or, where "y" has more
than one rank, the row-sharded loop of
``parallel/sharded_blending.py``.
"""

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from pysteps_tpu_torch import cascade, noise
from pysteps_tpu_torch._device import as_device_tensor, resolve_device
from pysteps_tpu_torch.blending import skill_scores
from pysteps_tpu_torch.blending.utils import compute_smooth_dilated_mask
from pysteps_tpu_torch.cascade.decomposition import decompose_core
from pysteps_tpu_torch.extrapolation.semilagrangian import (
    coarsen_velocity,
    integrate_displacement,
    integrate_displacement_coarse,
    upsample_displacement,
)
from pysteps_tpu_torch.noise import fftgenerators
from pysteps_tpu_torch.noise.motion import (
    _laplace,
    get_default_params_bps_par,
    get_default_params_bps_perp,
)
from pysteps_tpu_torch.nowcasts import utils as nowcast_utils
from pysteps_tpu_torch.nowcasts.steps import (
    _ar_step_lags,
    _estimate_params,
    _lagrangian_alignment,
    _sync,
)
from pysteps_tpu_torch.ops.warp import warp, warp_shifted
from pysteps_tpu_torch.parallel.mesh import all_gather_cat, axis_size, member_block
from pysteps_tpu_torch.postprocessing import probmatching
from pysteps_tpu_torch.utils import tapering
from pysteps_tpu_torch.utils.arrays import _nanmin
from pysteps_tpu_torch.utils.check_norain import nanmin, rain_count
from pysteps_tpu_torch.utils.profiling import annotate

# the largest static displacement bound of the shift path (pixels)
_MAX_DISP = 48
# leads a streaming callback gets at a time
_STREAM_LEADS = 4


@dataclasses.dataclass
class StepsBlendingState:
    """The loop's initial state.  ``cascades`` is the extrapolation
    cascade window (k, p, m, n), shared by the members; ``noise_cascades``
    the members' noise windows (E, k, p, m, n), zero when None."""

    cascades: torch.Tensor
    noise_cascades: Optional[torch.Tensor]
    precip_mask: torch.Tensor    # (m, n) initial rain mask (float)
    generator: torch.Generator   # the noise and resampling draws
    eps_par: Optional[torch.Tensor] = None    # (E,) BPS parallel draws
    eps_perp: Optional[torch.Tensor] = None   # (E,) BPS perpendicular draws


@dataclasses.dataclass
class StepsBlendingParams:
    """Quantities precomputed before the loop and constant inside it."""

    phi: torch.Tensor               # (k, p+1) radar AR parameters
    weights: torch.Tensor           # (T, n_models, 3, k) extrap/NWP/noise
    nwp_cascades: torch.Tensor      # (T, n_models, k, m, n) normalized
    nwp_means: torch.Tensor         # (T, n_models, k)
    nwp_sigmas: torch.Tensor        # (T, n_models, k)
    radar_means: torch.Tensor       # (k,)
    radar_sigmas: torch.Tensor      # (k,)
    noise_filter: torch.Tensor      # (m, n//2+1)
    noise_std_coeffs: torch.Tensor  # (k,)
    velocity_blend: torch.Tensor    # (T, n_models, 2, m, n)
    nwp_fields: torch.Tensor        # (T, n_models, m, n) NWP precipitation
    member_model: torch.Tensor      # (E,) int64 NWP model of each member
    weights_2d: torch.Tensor        # (k, m, n//2+1) bandpass filter bank
    precip_last: torch.Tensor       # (m, n) last radar field
    precip_min: torch.Tensor        # radar minimum
    domain_mask: torch.Tensor       # (m, n) True outside the radar domain
    smooth_mask: torch.Tensor       # (m, n) radar weight at the domain edge
    ext_cascades: Optional[torch.Tensor] = None  # (T, E, k, m, n) external
    ext_means: Optional[torch.Tensor] = None     # (T, k)
    ext_sigmas: Optional[torch.Tensor] = None    # (T, k)


@dataclasses.dataclass(frozen=True)
class StepsBlendingConfig:
    """Configuration of STEPS blending (the JAX package's fields);
    :class:`StepsBlendingNowcaster` maps them onto :func:`forecast`'s
    keyword arguments."""

    precip_threshold: Optional[float] = None
    norain_threshold: float = 0.0
    kmperpixel: Optional[float] = None
    timestep: Optional[float] = None
    n_ens_members: int = 24
    n_cascade_levels: int = 6
    blend_nwp_members: bool = False
    extrapolation_method: str = "semilagrangian"
    decomposition_method: str = "fft"
    bandpass_filter_method: str = "gaussian"
    noise_method: Optional[str] = "nonparametric"
    noise_stddev_adj: Optional[str] = None
    ar_order: int = 2
    velocity_perturbation_method: Optional[str] = None
    weights_method: str = "bps"
    conditional: bool = False
    probmatching_method: Optional[str] = "cdf"
    mask_method: Optional[str] = "incremental"
    resample_distribution: bool = True
    smooth_radar_mask_range: int = 0
    seed: Optional[int] = None
    num_workers: int = 1
    fft_method: str = "numpy"
    domain: str = "spatial"
    outdir_path_skill: Optional[str] = None
    extrapolation_kwargs: dict = dataclasses.field(default_factory=dict)
    filter_kwargs: dict = dataclasses.field(default_factory=dict)
    noise_kwargs: dict = dataclasses.field(default_factory=dict)
    velocity_perturbation_kwargs: dict = dataclasses.field(default_factory=dict)
    climatology_kwargs: dict = dataclasses.field(default_factory=dict)
    mask_kwargs: dict = dataclasses.field(default_factory=dict)
    measure_time: bool = False
    callback: object = None
    return_output: bool = True
    mesh: object = None


class StepsBlendingNowcaster:
    """Class front end over :func:`forecast`."""

    def __init__(self, precip, precip_models, velocity, velocity_models,
                 time_steps, issue_time=None, steps_blending_config=None, device=None):
        self.precip = precip
        self.precip_models = precip_models
        self.velocity = velocity
        self.velocity_models = velocity_models
        self.time_steps = time_steps
        self.issue_time = issue_time
        self.config = steps_blending_config or StepsBlendingConfig()
        self.device = device

    def compute_forecast(self):
        cfg = self.config
        return forecast(
            self.precip, self.precip_models, self.velocity,
            self.velocity_models, self.time_steps, cfg.timestep,
            issuetime=self.issue_time,
            n_ens_members=cfg.n_ens_members,
            n_cascade_levels=cfg.n_cascade_levels,
            blend_nwp_members=cfg.blend_nwp_members,
            precip_thr=cfg.precip_threshold,
            norain_thr=cfg.norain_threshold,
            kmperpixel=cfg.kmperpixel,
            extrap_method=cfg.extrapolation_method,
            decomp_method=cfg.decomposition_method,
            bandpass_filter_method=cfg.bandpass_filter_method,
            noise_method=cfg.noise_method,
            noise_stddev_adj=cfg.noise_stddev_adj,
            ar_order=cfg.ar_order,
            vel_pert_method=cfg.velocity_perturbation_method,
            weights_method=cfg.weights_method,
            conditional=cfg.conditional,
            probmatching_method=cfg.probmatching_method,
            mask_method=cfg.mask_method,
            resample_distribution=cfg.resample_distribution,
            smooth_radar_mask_range=cfg.smooth_radar_mask_range,
            callback=cfg.callback,
            return_output=cfg.return_output,
            seed=cfg.seed,
            num_workers=cfg.num_workers,
            fft_method=cfg.fft_method,
            domain=cfg.domain,
            outdir_path_skill=cfg.outdir_path_skill,
            extrap_kwargs=cfg.extrapolation_kwargs,
            filter_kwargs=cfg.filter_kwargs,
            noise_kwargs=cfg.noise_kwargs,
            vel_pert_kwargs=cfg.velocity_perturbation_kwargs,
            clim_kwargs=cfg.climatology_kwargs,
            mask_kwargs=cfg.mask_kwargs,
            measure_time=cfg.measure_time,
            mesh=cfg.mesh,
            device=self.device,
        )


def calculate_ratios(correlations):
    """Explained-variance ratios (reference: blending/steps.py:3819)."""
    sq = np.square(correlations)
    return sq / (1 - sq)


def calculate_weights_bps(correlations):
    """BPS2006 blending weights (reference: blending/steps.py:3844).

    correlations: (components, k, ...) -> weights (components+1, k, ...)
    with a trailing noise component."""
    correlations = np.where(correlations < 10e-5, 10e-5, correlations)
    if correlations.shape[0] > 1:
        ratios = calculate_ratios(correlations)
        total = np.sum(ratios, axis=0)
        weights = correlations * np.sqrt(ratios / total)
        noise_weight = np.sqrt(np.maximum(1.0 - np.sum(np.square(weights), axis=0), 0.0))
        return np.concatenate([weights, noise_weight[None]], axis=0)
    noise_weight = 1.0 - correlations
    return np.concatenate([correlations, noise_weight], axis=0)


def calculate_weights_spn(correlations, covariance):
    """SPN2013 covariance-inverse weights (reference:
    blending/steps.py:3905)."""
    correlations = np.where(correlations < 10e-5, 10e-5, np.asarray(correlations))
    if correlations.shape[0] > 1 and covariance is not None and np.ndim(covariance) == 2:
        covariance = np.where(covariance == 0.0, 10e-5, np.asarray(covariance, float))
        if np.linalg.det(covariance) == 0.0:
            covariance = covariance - 10e-5
        for i in range(len(covariance)):
            covariance[i][i] = 1.0
        cov_inv = np.linalg.inv(covariance)
        weights = cov_inv @ correlations
        weights = np.nan_to_num(weights, nan=10e-5, posinf=10e-5, neginf=10e-5)
        wdc = np.sum(weights * correlations)
        noise_weight = np.array([0.0]) if wdc > 1.0 else np.sqrt(1.0 - wdc)
        weights = np.concatenate(
            [np.asarray(weights).ravel(), np.atleast_1d(noise_weight).ravel()]
        )
        return np.nan_to_num(weights, nan=10e-5, posinf=10e-5, neginf=10e-5)
    noise_weight = 1.0 - correlations
    return np.concatenate([correlations, noise_weight], axis=0)


def calculate_end_weights(
    previous_weights, timestep, n_timesteps, start_full_nwp_weight, model_only=False
):
    """Linear transition to full-NWP weight near the forecast end
    (reference: blending/steps.py:3987)."""
    weights = np.array(previous_weights[:-1], copy=True)
    frac = (timestep - start_full_nwp_weight) / max(n_timesteps - start_full_nwp_weight, 1e-6)
    frac = np.clip(frac, 0.0, 1.0)
    # component 0 is the extrapolation; the rest are NWP models
    if not model_only:
        weights[0] = (1 - frac) * weights[0]
        weights[1:] = weights[1:] + frac * (1.0 - weights[1:]) / max(weights.shape[0] - 1, 1)
    noise_weight = np.sqrt(np.maximum(1.0 - np.sum(weights**2, axis=0), 0.0))
    return np.concatenate([weights, noise_weight[None]], axis=0)


def blend_means_sigmas(means, sigmas, weights, device=None):
    """Weighted blend of normalization statistics (reference:
    blending/steps.py:4093; BPS2004 eq. 32-33): ``weights``
    (components+1, ...) with the noise component last, ``means`` and
    ``sigmas`` (components, ...).  Float32 tensors on ``weights``'
    device."""
    weights = as_device_tensor(weights, device, torch.float32)[:-1]
    means = as_device_tensor(means, weights.device, torch.float32)
    sigmas = as_device_tensor(sigmas, weights.device, torch.float32)
    while means.ndim < weights.ndim:
        means = means[..., None]
    while sigmas.ndim < weights.ndim:
        sigmas = sigmas[..., None]
    total = torch.clamp(weights.sum(dim=0), min=1e-12)
    return (weights / total * means).sum(dim=0), (weights / total * sigmas).sum(dim=0)


def _presort_targets(precip_last, nwp_fields, precip_min):
    """The resampled CDF match's descending-sorted intensities: the last
    radar field's (N,) and each (lead, model) NWP field's (T, n_models, N)
    with NaN set to the radar minimum, sorted one lead at a time."""
    rsort_desc = torch.sort(precip_last.reshape(-1), descending=True).values
    T, nm = nwp_fields.shape[:2]
    nsorts = torch.empty((T, nm, precip_last.numel()), dtype=nwp_fields.dtype,
                         device=nwp_fields.device)
    for t in range(T):
        flat = torch.where(torch.isnan(nwp_fields[t]), precip_min, nwp_fields[t])
        nsorts[t] = torch.sort(flat.reshape(nm, -1), dim=-1, descending=True).values
    return rsort_desc, nsorts


def _match_cdf_targets(field, target):
    """Exact CDF match of each member of ``field`` (E, m, n) to its own
    target sample (E, N): the JAX package's ``_match_cdf_core`` per
    member."""
    z = _nanmin(target, dim=1)
    ranked = torch.sort(torch.where(torch.isnan(target), z[:, None], target), dim=1).values
    return probmatching._match_cdf_presorted(field, ranked, z, exact=True)


def params_from_numpy(arrays, device, seed):
    """The port's (params, state) from the JAX forecast's precomputed
    init given as numpy arrays under the names of the JAX package's
    ``_blending_scan`` arguments: ``window``, ``mask_prec_init``,
    ``velocity_blend``, ``nwp_cascades``, ``nwp_means``, ``nwp_sigmas``,
    ``nwp_fields``, ``member_model``, ``weights_t``, ``phi``,
    ``noise_filt``, ``weights_2d``, ``noise_std_coeffs``, ``radar_means``,
    ``radar_sigmas``, ``precip_last``, ``precip_min``, ``domain_mask``,
    ``smooth_mask`` and, where given, ``ext_cascades``, ``ext_means``,
    ``ext_sigmas``, ``eps_par``, ``eps_perp``.  JAX's member keys have no
    counterpart; ``seed`` seeds the port's generator instead."""
    device = torch.device(device)

    def t(name, dtype=None):
        x = arrays.get(name)
        return None if x is None else torch.as_tensor(np.array(x), dtype=dtype, device=device)

    params = StepsBlendingParams(
        phi=t("phi", torch.float32), weights=t("weights_t", torch.float32),
        nwp_cascades=t("nwp_cascades", torch.float32),
        nwp_means=t("nwp_means", torch.float32), nwp_sigmas=t("nwp_sigmas", torch.float32),
        radar_means=t("radar_means", torch.float32),
        radar_sigmas=t("radar_sigmas", torch.float32),
        noise_filter=t("noise_filt", torch.float32),
        noise_std_coeffs=t("noise_std_coeffs", torch.float32),
        velocity_blend=t("velocity_blend", torch.float32),
        nwp_fields=t("nwp_fields", torch.float32), member_model=t("member_model", torch.int64),
        weights_2d=t("weights_2d", torch.float32), precip_last=t("precip_last", torch.float32),
        precip_min=t("precip_min", torch.float32), domain_mask=t("domain_mask", torch.bool),
        smooth_mask=t("smooth_mask", torch.float32),
        ext_cascades=t("ext_cascades", torch.float32), ext_means=t("ext_means", torch.float32),
        ext_sigmas=t("ext_sigmas", torch.float32),
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    state = StepsBlendingState(
        cascades=t("window", torch.float32), noise_cascades=None,
        precip_mask=t("mask_prec_init", torch.float32), generator=gen,
        eps_par=t("eps_par", torch.float32), eps_perp=t("eps_perp", torch.float32),
    )
    return params, state


def _blending_scan(
    params, state, int_steps, mask_method, probmatching_method, resample_distribution,
    mask_rim, struct_radius, precip_thr, max_disp=None, vel_pert=False, p_par=None,
    p_perp=None, vsf=1.0, timestep_min=1.0, use_noise=True, members=None, draw_all=False,
    sorts=None, out=None, out_dtype="float32", callback=None,
):
    """The blended forecast loop over ``int_steps`` leads for the members
    ``members`` (a slice; all by default).  Returns their member-major
    (E, T, m, n) output, written into ``out`` when given; with
    ``callback``, hands each lead's (E, m, n) frames to it as host numpy
    arrays, fetched every 4 leads from a buffer of that many, and returns
    None.

    ``max_disp`` (a static displacement bound, or None for the exact
    gather) chooses the path; the device of the tensors chooses between
    the kernels and their plain versions.  ``sorts`` are the
    :func:`_presort_targets` of the resampled CDF match, made here when
    None.  With ``draw_all`` the noise and the picks are drawn for every
    member of ``params`` and ``members``' draws kept, so that a block of
    members equals the same members of the whole ensemble."""
    members = members if members is not None else slice(None)
    mm = params.member_model[members]
    E = mm.shape[0]
    mm_draw, keep = (params.member_model, members) if draw_all else (mm, None)
    E_draw = mm_draw.shape[0]
    k_levels, p, m, n = state.cascades.shape
    dev = state.cascades.device
    gen = state.generator
    phi = params.phi
    external = params.ext_cascades is not None

    ext_lags = tuple(state.cascades[:, i] for i in range(p))  # (k, m, n) each
    if use_noise:
        if state.noise_cascades is None:
            noise_lags = tuple(torch.zeros((E, k_levels, m, n), device=dev) for _ in range(p))
        else:
            noise_lags = tuple(state.noise_cascades[members, :, i] for i in range(p))
    mask = state.precip_mask.expand(E, m, n)

    # the displacement is carried on a coarse grid when a static bound is
    # known (full-resolution pixel units at coarse positions)
    coarse = 4 if (max_disp is not None and m % 4 == 0 and n % 4 == 0) else 1
    vel_all = coarsen_velocity(params.velocity_blend, coarse)
    disp = torch.zeros((E, 2, m // coarse, n // coarse), dtype=torch.float32, device=dev)
    if vel_pert:
        eps_par = state.eps_par[members, None, None, None]
        eps_perp = state.eps_perp[members, None, None, None]

    if probmatching_method == "cdf":
        if resample_distribution:
            rsort, nsorts = sorts if sorts is not None else _presort_targets(
                params.precip_last, params.nwp_fields, params.precip_min)
        else:
            ranked, zvalue = probmatching._prepare_cdf_target(params.precip_last)
    elif probmatching_method == "mean":
        wet_obs = params.precip_last >= precip_thr
        mu_obs = torch.where(wet_obs, params.precip_last, 0.0).sum() / torch.clamp(
            wet_obs.sum(), min=1)

    buf_leads = min(_STREAM_LEADS, int_steps) if callback is not None else int_steps
    if out is None:
        out = torch.empty((E, buf_leads, m, n), dtype=getattr(torch, out_dtype), device=dev)
    rows = torch.arange(E, device=dev)
    nm = params.weights.shape[1]
    need_warp = (not external) or use_noise
    t0 = 0
    for t in range(int_steps):
        with annotate("pst.lead"):
            with annotate("pst.update"):
                # AR evolution of the extrapolation and noise cascades
                if not external:
                    ext_lags = _ar_step_lags(ext_lags, phi)
                if use_noise:
                    eps = fftgenerators._generate_fft_noise(
                        gen, params.noise_filter, (m, n), E_draw, domain="spatial",
                        standardize=False, keep=keep)
                    eps_levels, _, _ = decompose_core(eps, params.weights_2d, normalize=True)
                    eps_levels = eps_levels * params.noise_std_coeffs[:, None, None]
                    noise_lags = _ar_step_lags(noise_lags, phi, eps=eps_levels)

                # blend weights and recomposition coefficients (E, k)
                w = params.weights[t].index_select(0, mm)  # (E, 3, k)
                wsum = torch.clamp(w.sum(dim=1), min=1e-12)
                if external:
                    r_means = params.ext_means[t].expand(E, k_levels)
                    r_sigmas = params.ext_sigmas[t].expand(E, k_levels)
                else:
                    r_means = params.radar_means.expand(E, k_levels)
                    r_sigmas = params.radar_sigmas.expand(E, k_levels)
                means = torch.stack([r_means, params.nwp_means[t].index_select(0, mm)])
                sigmas = torch.stack([r_sigmas, params.nwp_sigmas[t].index_select(0, mm)])
                c_means, c_sigmas = blend_means_sigmas(means, sigmas, w.transpose(0, 1))
                a_ext = w[:, 0] * c_sigmas / wsum
                a_nwp = w[:, 1] * c_sigmas / wsum
                a_noi = w[:, 2] * c_sigmas / wsum

                # the Lagrangian composite: everything that is advected, weighted
                comp = torch.zeros((E, m, n), dtype=torch.float32, device=dev)
                if not external:
                    comp = torch.einsum("ek,kmn->emn", a_ext, ext_lags[-1])
                if use_noise:
                    comp = comp + torch.einsum("ekmn,ek->emn", noise_lags[-1], a_noi)

            with annotate("pst.warp"):
                # the member's blended advection, BPS-perturbed along its direction
                vel_j = vel_all[t].index_select(0, mm)
                if vel_pert:
                    t_total = np.float32((t + 1.0) * timestep_min)
                    a1, b1, c1 = (np.float32(v) for v in p_par)
                    a2, b2, c2 = (np.float32(v) for v in p_perp)
                    g_par = float(a1 * t_total**b1 + c1)
                    g_perp = float(a2 * t_total**b2 + c2)
                    nv = torch.linalg.vector_norm(vel_j, dim=1, keepdim=True)
                    v_n = torch.where(nv > 1e-12, vel_j / torch.clamp(nv, min=1e-12), 0.0)
                    v_perp = torch.stack([-v_n[:, 1], v_n[:, 0]], dim=1)
                    vel_j = vel_j + (eps_par * g_par * v_n + eps_perp * g_perp * v_perp) / vsf

                if max_disp is not None:
                    disp = integrate_displacement_coarse(vel_j, disp, 1.0, max_disp=max_disp,
                                                         coarse=coarse)
                    if need_warp:
                        disp_full = upsample_displacement(disp, (m, n), coarse)
                        comp = warp_shifted(comp, disp_full, max_disp, cval=0.0)
                else:
                    disp = integrate_displacement(vel_j, disp, 1.0)
                    if need_warp:
                        comp = warp(comp, disp, order=1, cval=0.0)

            with annotate("pst.update"):
                # the NWP levels enter as one contraction over (model, level):
                # each member's coefficients sit in its model's slot
                a_models = torch.zeros((E, nm, k_levels), dtype=torch.float32, device=dev)
                a_models[rows, mm] = a_nwp
                field = comp + torch.einsum("ejk,jkmn->emn", a_models, params.nwp_cascades[t])
                field = field + c_means.sum(dim=1)[:, None, None]
                if external:
                    field = field + torch.einsum("ekmn,ek->emn", params.ext_cascades[t, members],
                                                 a_ext)

                # post-processing: NWP outside the radar domain, smooth transition
                nwp_field = params.nwp_fields[t].index_select(0, mm)
                field = torch.where(params.domain_mask, nwp_field, field)
                field = params.smooth_mask * field + (1.0 - params.smooth_mask) * nwp_field

            with annotate("pst.mask"):
                fmin = torch.minimum(field.amin(dim=(-2, -1)), params.precip_min)[:, None, None]
                if mask_method == "incremental":
                    field = fmin + (field - fmin) * mask
                    field = torch.where(field > fmin, field, fmin)
                elif mask_method == "obs":
                    field = torch.where(mask > 0, field, fmin)

            with annotate("pst.match"):
                if probmatching_method == "cdf":
                    if resample_distribution:
                        # binomial mix of the radar and NWP intensity
                        # distributions, weighted by the current extrapolation
                        # skill
                        w_d = w if keep is None else params.weights[t].index_select(0, mm_draw)
                        s0, s1 = w_d[:, 0].sum(dim=1), w_d[:, 1].sum(dim=1)
                        p_radar = s0 / torch.clamp(s0 + s1, min=1e-12)
                        pick = probmatching._bernoulli(gen, p_radar[:, None], (E_draw, m * n))
                        if keep is not None:
                            pick = pick[keep]
                        target = torch.where(pick, rsort, nsorts[t].index_select(0, mm))
                        field = _match_cdf_targets(field, target)
                    else:
                        field = probmatching._match_cdf_presorted(field, ranked, zvalue,
                                                                  exact=True)
                elif probmatching_method == "mean":
                    wet = field >= precip_thr
                    mu_fct = torch.where(wet, field, 0.0).sum(
                        dim=(-2, -1), keepdim=True) / torch.clamp(
                        wet.sum(dim=(-2, -1), keepdim=True), min=1)
                    field = torch.where(wet, field - mu_fct + mu_obs, field)

            if mask_method == "incremental":
                with annotate("pst.mask"):
                    mask = nowcast_utils.compute_dilated_mask(field >= precip_thr,
                                                              struct_radius, mask_rim)

            with annotate("pst.write"):
                out[:, t - t0] = field.to(out.dtype)
        if callback is not None and (t + 1 - t0 == buf_leads or t + 1 == int_steps):
            with annotate("pst.stream"):
                nowcast_utils.stream_leads(out, t + 1 - t0, callback)
            t0 = t + 1
    return None if callback is not None else out


def _speed_bound(vmax, int_steps, timestep, vel_pert, p_par, p_perp, vsf):
    """The largest blended speed over the forecast, ``vmax``, plus a
    4-sigma margin for the BPS perturbation (px a lead)."""
    if vel_pert:
        t_last = int_steps * (timestep or 1.0)
        g_par_l = abs(p_par[0] * t_last ** p_par[1] + p_par[2])
        g_perp_l = abs(p_perp[0] * t_last ** p_perp[1] + p_perp[2])
        return vmax + 4.0 * max(g_par_l, g_perp_l) / max(vsf, 1e-6)
    return vmax


def _scan_bound(vmax, int_steps, timestep, vel_pert, p_par, p_perp, vsf, shape):
    """The static displacement bound of the card's path (the JAX package's
    TPU branch): the largest blended speed over the forecast, ``vmax``,
    with a 4-sigma margin for the BPS perturbation, plus 2 px, at most 48
    and at most a third of the grid (else None)."""
    speed = _speed_bound(vmax, int_steps, timestep, vel_pert, p_par, p_perp, vsf)
    max_disp = max(int(np.ceil(int_steps * speed)) + 2, 2)
    max_disp = min(max_disp, _MAX_DISP)
    if max_disp > min(shape) // 3:
        return None
    return max_disp


@dataclasses.dataclass
class ScanInputs:
    """What the forecast prepares for its loop: the arguments of
    ``_blending_scan`` and of ``parallel.sharded_blending.
    blending_scan_sharded`` (``params``, ``state``, ``int_steps`` and the
    keyword ``statics``), and ``vmax_bound``, the blended velocity's
    largest speed plus the BPS margin, which sizes the sharded loop's
    halo."""

    params: StepsBlendingParams
    state: StepsBlendingState
    int_steps: int
    statics: dict
    vmax_bound: float


def _leads(timesteps):
    """(int_steps, subsel): the loop's lead count, and the list of
    requested (possibly fractional) leads or None for an int."""
    if isinstance(timesteps, int):
        return timesteps, None
    subsel = list(timesteps)
    return int(np.ceil(max(subsel))), subsel


def scan_inputs(
    precip,
    precip_models,
    velocity,
    velocity_models,
    timesteps,
    timestep,
    n_ens_members=24,
    n_cascade_levels=6,
    blend_nwp_members=False,
    precip_thr=None,
    norain_thr=0.0,
    kmperpixel=None,
    bandpass_filter_method="gaussian",
    noise_method="nonparametric",
    noise_stddev_adj=None,
    ar_order=2,
    vel_pert_method=None,
    weights_method="bps",
    conditional=False,
    probmatching_method="cdf",
    mask_method="incremental",
    resample_distribution=True,
    smooth_radar_mask_range=0,
    seed=None,
    outdir_path_skill=None,
    extrap_kwargs=None,
    filter_kwargs=None,
    noise_kwargs=None,
    vel_pert_kwargs=None,
    clim_kwargs=None,
    mask_kwargs=None,
    precip_nowcast=None,
    timestep_start_full_nwp_weight=None,
    device=None,
):
    """The loop's inputs as :func:`forecast` prepares them from its
    arguments of the same names (a :class:`ScanInputs` on ``device``), or
    None where neither the radar nor the NWP fields rain."""
    device = resolve_device(device, precip, precip_models, velocity, velocity_models)
    extrap_kwargs = dict(extrap_kwargs or {})
    mask_kwargs = dict(mask_kwargs or {})
    noise_kwargs = dict(noise_kwargs or {})
    clim_kwargs = dict(clim_kwargs or {})
    filter_kwargs = filter_kwargs or {}
    int_steps, _ = _leads(timesteps)
    if precip_thr is None:
        raise ValueError("precip_thr required")
    host = nowcast_utils.to_numpy
    with annotate("pst.init.norain"):
        # every field crosses to the device once, as float32; frames older
        # than the AR window stay where they lie and count in the radar's
        # gate alone
        if not isinstance(precip, torch.Tensor):
            precip = np.asarray(precip)
        radar_size = math.prod(precip.shape)
        older = precip[: -(ar_order + 1)]
        precip_t = as_device_tensor(precip[-(ar_order + 1):], device, torch.float32)
        nwp_t = as_device_tensor(precip_models, device, torch.float32)
        velocity_t = as_device_tensor(velocity, device, torch.float32)
        velocity_models_t = as_device_tensor(velocity_models, device, torch.float32)
        if nwp_t.ndim == 3:
            nwp_t = nwp_t[:, None].expand(-1, int_steps + 1, -1, -1)
        n_models = nwp_t.shape[0]
        if velocity_models_t.ndim == 3:
            velocity_models_t = velocity_models_t[None]
        m, n = precip_t.shape[-2:]

        # the no-rain gates of radar and NWP, the radar's smallest value and
        # whether its domain has holes come to the host in one read
        n_radar = rain_count(precip_t, precip_thr)
        if len(older):
            on = older.device if isinstance(older, torch.Tensor) else "cpu"
            n_radar = n_radar + rain_count(
                as_device_tensor(older, on, torch.float32), precip_thr).to(device)
        domain_mask_t = ~torch.isfinite(precip_t[-1])
        precip_min_t = nanmin(precip_t)
        n_radar, n_nwp, precip_min, holes = torch.stack([
            n_radar.double(), rain_count(nwp_t, precip_thr).double(), precip_min_t.double(),
            domain_mask_t.any().double(),
        ]).tolist()
        if n_radar / radar_size <= norain_thr and n_nwp / nwp_t.numel() <= norain_thr:
            return None

        precip_t = torch.where(torch.isfinite(precip_t), precip_t, precip_min_t)
        nwp_t = torch.where(torch.isfinite(nwp_t), nwp_t, precip_min_t)

    with annotate("pst.init.filter"):
        bp_filter = cascade.get_method(bandpass_filter_method)((m, n), n_cascade_levels,
                                                               **filter_kwargs)
        weights_2d = torch.tensor(np.asarray(bp_filter["weights_2d"]), dtype=torch.float32,
                                  device=device)

    # radar cascades and AR parameters (the nowcast's machinery)
    if conditional:
        mask_thr = torch.all(precip_t >= precip_thr, dim=0)
    else:
        mask_thr = torch.ones((m, n), dtype=torch.bool, device=device)
    with annotate("pst.init.align"):
        precip_aligned = _lagrangian_alignment(precip_t, velocity_t)
    with annotate("pst.init.decompose"):
        cascades_full, means, stds, _, phi = _estimate_params(
            precip_aligned, weights_2d, mask_thr, ar_order, conditional)
        radar_means, radar_sigmas = means[-1], stds[-1]
        window = cascades_full[:, -ar_order:]

    # every model's and lead's NWP cascade in one batched decomposition
    with annotate("pst.init.nwp_decompose"):
        nwp_levels, nwp_means_all, nwp_sigmas_all = decompose_core(
            nwp_t[:, : int_steps + 1].contiguous(), weights_2d, normalize=True
        )  # (n_models, T+1, k, m, n), (n_models, T+1, k)

    with annotate("pst.init.rho0"):
        # the NWP skill at t=0 against the latest radar cascade
        rho_0 = np.stack([
            skill_scores.spatial_correlation(cascades_full[:, -1], nwp_levels[im, 0],
                                             domain_mask_t)
            for im in range(n_models)
        ])  # (n_models, k)

    with annotate("pst.init.skill"):
        # the per-lead weights, on the host (they do not depend on the state)
        from pysteps_tpu_torch.config import rcparams

        outdir = outdir_path_skill or rcparams["outputs"]["path_workdir"]
        phi_np = phi.cpu().numpy()
        weights_t = np.zeros((int_steps, n_models, 3, n_cascade_levels), np.float32)
        rho_extrap_prev = None
        rho_extrap = None
        casc_last_np = host(cascades_full[:, -1]) if weights_method == "spn" else None
        for t in range(int_steps):
            lt = (t + 1) * float(timestep)
            rho_extrap, rho_extrap_prev = skill_scores.lt_dependent_cor_extrapolation(
                phi_np[:, :ar_order + 1], rho_extrap, rho_extrap_prev, ar_order)
            for im in range(n_models):
                rho_nwp = skill_scores.lt_dependent_cor_nwp(
                    lt, rho_0[im], outdir, n_model=im,
                    skill_kwargs={"n_models": n_models, **clim_kwargs})
                corr = np.stack([np.asarray(rho_extrap), rho_nwp])
                if weights_method == "bps":
                    w = calculate_weights_bps(corr)  # (3, k)
                elif weights_method == "spn":
                    nwp_np = host(nwp_levels[im, t])
                    w = np.stack([
                        calculate_weights_spn(
                            corr[:, k_i],
                            np.corrcoef(np.stack([casc_last_np[k_i].ravel(),
                                                  nwp_np[k_i].ravel()])))
                        for k_i in range(n_cascade_levels)
                    ], axis=1)
                else:
                    raise ValueError(f"unknown weights_method {weights_method}")
                # linear transition to full-NWP weight near the forecast end
                if (timestep_start_full_nwp_weight is not None
                        and t + 1 > timestep_start_full_nwp_weight):
                    w = calculate_end_weights(w, t + 1, int_steps,
                                              timestep_start_full_nwp_weight)
                weights_t[t, im] = w

    with annotate("pst.init.velocity"):
        # the blended advection of each lead, weighted by the second cascade
        # level's weights; static (n_models, 2, m, n) or time-varying
        # (n_models, T+1, 2, m, n) model velocities.  One float32 op at a
        # time, as numpy computes it: no fused multiply-add, and a division
        # by a tensor (by a Python float the card multiplies by a rounded
        # reciprocal)
        weights = torch.as_tensor(weights_t, device=device)
        w_extrap = weights[:, :, 0, 1, None, None, None]  # (T, n_models, 1, 1, 1)
        w_nwp = weights[:, :, 1, 1, None, None, None]
        tot = torch.clamp(w_extrap + w_nwp, min=1e-12)
        if velocity_models_t.ndim == 5:
            idx = torch.arange(1, int_steps + 1, device=device).clamp(
                max=velocity_models_t.shape[1] - 1)
            vm_t = velocity_models_t[:, idx].transpose(0, 1)  # (T, n_models, 2, m, n)
        else:
            vm_t = velocity_models_t[None, :, :2]
        velocity_blend = w_extrap * velocity_t
        velocity_blend += w_nwp * vm_t
        velocity_blend /= tot
        if blend_nwp_members:
            velocity_blend = velocity_blend.mean(dim=1, keepdim=True)
        del velocity_t, velocity_models_t, vm_t

    with annotate("pst.init.noise"):
        # the noise filter, built on the device from the aligned inputs
        if noise_method == "nonparametric" and set(noise_kwargs) <= {"win_fun"}:
            win_fun = noise_kwargs.get("win_fun", "tukey")
            taper = torch.as_tensor(
                tapering.compute_window_function(m, n, win_fun) if win_fun is not None
                else np.ones((m, n)), dtype=torch.float32, device=device)
            noise_filt = fftgenerators.nonparam_filter_core(precip_aligned, taper).to(
                torch.float32)
            pert_gen = {"field": noise_filt, "input_shape": (m, n), "use_full_fft": False}
        elif noise_method is not None:
            init_noise, _ = noise.get_method(noise_method)
            pert_gen = init_noise(precip_aligned, **noise_kwargs)
            noise_filt = torch.as_tensor(pert_gen["field"], dtype=torch.float32, device=device)
            if noise_filt.ndim != 2:
                raise ValueError(f"noise_method {noise_method} gives no global filter")
            if pert_gen.get("use_full_fft"):
                # the loop multiplies rfft2 half-planes; a full-plane filter
                # magnitude is Hermitian-symmetric, so its left half is the
                # half-plane filter
                noise_filt = noise_filt[:, : n // 2 + 1]
        else:
            noise_filt = torch.ones((m, n // 2 + 1), dtype=torch.float32, device=device)
        noise_std_coeffs = torch.ones(n_cascade_levels, dtype=torch.float32, device=device)
        if noise_stddev_adj == "auto" and noise_method is not None:
            gen_adj = torch.Generator(device=device)
            gen_adj.manual_seed((seed or 42) + 1)
            noise_std_coeffs = noise.utils.compute_noise_stddev_adjs(
                precip_t[-1], precip_thr, precip_min, bp_filter, None, pert_gen, None, 20,
                conditional=True, generator=gen_adj).to(torch.float32)
        elif noise_stddev_adj == "fixed":
            noise_std_coeffs = torch.tensor(
                [1.0 / (0.75 + 0.09 * k) for k in range(1, n_cascade_levels + 1)],
                dtype=torch.float32, device=device)

    # the member-model pairing
    with annotate("pst.init.copy"):
        # the loop's NWP fields, held apart from the stack, which is freed
        precip_models_t = nwp_t[:, 1: int_steps + 1].clone()
    del nwp_t
    if blend_nwp_members:
        member_model = torch.zeros(n_ens_members, dtype=torch.int64, device=device)
        # all models as one pseudo-model: their normalized cascades,
        # statistics, weights and velocities averaged
        nwp_levels = nwp_levels.mean(dim=0, keepdim=True)
        nwp_means_all = nwp_means_all.mean(dim=0, keepdim=True)
        nwp_sigmas_all = nwp_sigmas_all.mean(dim=0, keepdim=True)
        weights = torch.as_tensor(weights_t.mean(axis=1, keepdims=True), device=device)
        precip_models_t = precip_models_t.mean(dim=0, keepdim=True)
    else:
        member_model = torch.arange(n_ens_members, device=device) % n_models

    with annotate("pst.init.mask"):
        # masks
        mask_rim = int(mask_kwargs.get("mask_rim", 10))
        struct_radius = 1
        if timestep is not None and kmperpixel:
            struct_radius = max(
                int((mask_kwargs.get("mask_f", 1.0) * timestep / kmperpixel - 1) / 2.0), 1)
        wet = precip_t[-1] >= precip_thr
        if mask_method == "incremental":
            mask_prec_init = nowcast_utils.compute_dilated_mask(
                wet[None], struct_radius, mask_rim)[0].to(torch.float32)
        elif mask_method == "obs":
            mask_prec_init = wet.to(torch.float32)
        else:
            mask_prec_init = torch.ones((m, n), dtype=torch.float32, device=device)

        # the smooth radar-domain mask
        if smooth_radar_mask_range and holes:
            smooth_mask = compute_smooth_dilated_mask(
                ~domain_mask_t, max_padding_size_in_px=int(smooth_radar_mask_range))
        else:
            smooth_mask = torch.ones((m, n), dtype=torch.float32, device=device)

    with annotate("pst.init.bps"):
        generator = torch.Generator(device=device)
        generator.manual_seed(seed if seed is not None else 42)

        # velocity perturbations: one BPS draw pair a member
        vel_pert = vel_pert_method is not None
        if vel_pert:
            vpk = dict(vel_pert_kwargs or {})
            p_par = tuple(float(v) for v in vpk.get("p_par", get_default_params_bps_par()))
            p_perp = tuple(float(v) for v in vpk.get("p_perp", get_default_params_bps_perp()))
            vsf = 60.0 / (timestep * (1.0 / kmperpixel)) if (timestep and kmperpixel) else 1.0
            gen_vel = torch.Generator(device=device)
            gen_vel.manual_seed((seed if seed is not None else 42) + 7)
            eps_par = _laplace(gen_vel, (n_ens_members,))
            eps_perp = _laplace(gen_vel, (n_ens_members,))
        else:
            p_par = p_perp = None
            vsf = 1.0
            eps_par = eps_perp = None

    with annotate("pst.init.velocity"):
        vmax = float(velocity_blend.abs().max()) if velocity_blend.numel() else 0.0
        vmax_bound = _speed_bound(vmax, int_steps, timestep, vel_pert, p_par, p_perp, vsf)
        # the card's path takes the static bound; the CPU the exact gather
        if device.type == "cpu":
            max_disp = None
        else:
            max_disp = _scan_bound(vmax, int_steps, timestep, vel_pert, p_par, p_perp, vsf,
                                   (m, n))
        if "max_disp" in extrap_kwargs:
            max_disp = extrap_kwargs["max_disp"]

    # the external nowcast, decomposed per member and lead
    ext_cascades = ext_means = ext_sigmas = None
    if precip_nowcast is not None:
        pn = host(precip_nowcast).astype(np.float32)
        if pn.shape[0] != n_ens_members:
            raise ValueError("precip_nowcast must have n_ens_members members")
        pn = np.where(np.isfinite(pn), pn, precip_min)
        ext_levels, ext_means_em, ext_sigmas_em = decompose_core(
            torch.as_tensor(pn[:, :int_steps], device=device), weights_2d, normalize=True)
        ext_cascades = ext_levels.transpose(0, 1).contiguous()  # (T, E, k, m, n)
        ext_means = ext_means_em.mean(dim=0)  # (T, k)
        ext_sigmas = ext_sigmas_em.mean(dim=0)

    with annotate("pst.init.copy"):
        params = StepsBlendingParams(
            phi=phi.to(torch.float32), weights=weights,
            nwp_cascades=nwp_levels[:, 1: int_steps + 1].transpose(0, 1).contiguous(),
            nwp_means=nwp_means_all[:, 1: int_steps + 1].transpose(0, 1).contiguous(),
            nwp_sigmas=nwp_sigmas_all[:, 1: int_steps + 1].transpose(0, 1).contiguous(),
            radar_means=radar_means, radar_sigmas=radar_sigmas, noise_filter=noise_filt,
            noise_std_coeffs=noise_std_coeffs, velocity_blend=velocity_blend.contiguous(),
            nwp_fields=precip_models_t.transpose(0, 1).contiguous(), member_model=member_model,
            weights_2d=weights_2d, precip_last=precip_t[-1],
            precip_min=precip_min_t,
            domain_mask=domain_mask_t, smooth_mask=smooth_mask.to(torch.float32),
            ext_cascades=ext_cascades, ext_means=ext_means, ext_sigmas=ext_sigmas,
        )
    state = StepsBlendingState(
        cascades=window.to(torch.float32), noise_cascades=None, precip_mask=mask_prec_init,
        generator=generator, eps_par=eps_par, eps_perp=eps_perp,
    )
    statics = dict(
        mask_method=mask_method, probmatching_method=probmatching_method,
        resample_distribution=bool(resample_distribution), mask_rim=mask_rim,
        struct_radius=struct_radius, precip_thr=float(precip_thr), max_disp=max_disp,
        vel_pert=vel_pert, p_par=p_par, p_perp=p_perp, vsf=vsf,
        timestep_min=float(timestep) if timestep else 1.0, use_noise=noise_method is not None,
    )
    return ScanInputs(params, state, int_steps, statics, vmax_bound)


def forecast(
    precip,
    precip_models,
    velocity,
    velocity_models,
    timesteps,
    timestep,
    issuetime=None,
    n_ens_members=24,
    n_cascade_levels=6,
    blend_nwp_members=False,
    precip_thr=None,
    norain_thr=0.0,
    kmperpixel=None,
    extrap_method="semilagrangian",
    decomp_method="fft",
    bandpass_filter_method="gaussian",
    noise_method="nonparametric",
    noise_stddev_adj=None,
    ar_order=2,
    vel_pert_method=None,
    weights_method="bps",
    conditional=False,
    probmatching_method="cdf",
    mask_method="incremental",
    resample_distribution=True,
    smooth_radar_mask_range=0,
    callback=None,
    return_output=True,
    seed=None,
    num_workers=1,
    fft_method="numpy",
    domain="spatial",
    outdir_path_skill=None,
    extrap_kwargs=None,
    filter_kwargs=None,
    noise_kwargs=None,
    vel_pert_kwargs=None,
    clim_kwargs=None,
    mask_kwargs=None,
    measure_time=False,
    precip_nowcast=None,
    nowcasting_method="steps",
    timestep_start_full_nwp_weight=None,
    mesh=None,
    output_dtype="float32",
    member_chunk=None,
    device=None,
):
    """STEPS blending forecast with the JAX package's signature plus
    ``device``.

    precip: (ar_order+1, m, n) radar fields (transformed units).
    precip_models: (n_models, T+1, m, n) raw NWP fields in the same units,
    or (n_models, m, n) static fields repeated.  velocity_models:
    (n_models, 2, m, n), or (n_models, T+1, 2, m, n) time-varying.
    precip_nowcast: an external nowcast ensemble (n_ens_members, T, m, n)
    used as the extrapolation component (``nowcasting_method=
    "external_nowcast"`` requires it).  timestep_start_full_nwp_weight:
    the lead index after which the weights move linearly to full NWP
    weight.  Returns an (n_ens_members, T, m, n) tensor on ``device``
    (CUDA unless the caller asks for the CPU or passes CPU tensors;
    ``RuntimeError`` when CUDA is needed and absent).  ``callback`` gets
    each lead's (E, m, n) frames as host numpy arrays; with
    ``return_output=False`` (and an int ``timesteps``) they stream in
    chunks of at most 4 leads and the forecast returns None.

    ``mesh`` (a ``parallel.make_mesh`` mesh of the forecast's device type;
    every rank calls the forecast with the same inputs) routes as the JAX
    package does.  Where its "y" dimension has one rank, the members split
    over "ens" when it has more than one rank and divides the member
    count: a rank draws every member's noise and picks and keeps its
    block's, so the result equals the unsharded forecast, and one
    all-gather returns every member to every rank (``member_chunk`` does
    not apply then, and the callback gets the gathered frames).  Where "y"
    has more than one rank, the loop runs row-sharded through
    ``parallel.sharded_blending.blending_scan_sharded`` (no external
    nowcast, no ``member_chunk``; the callback gets the frames after the
    loop)."""
    with annotate("pst.gate"):
        if nowcasting_method not in ("steps", "external_nowcast"):
            raise ValueError(
                f"unknown nowcasting_method {nowcasting_method}; "
                "must be 'steps' or 'external_nowcast'"
            )
        if nowcasting_method == "external_nowcast" and precip_nowcast is None:
            raise ValueError("nowcasting_method='external_nowcast' requires precip_nowcast")
        if timestep_start_full_nwp_weight is not None and timestep_start_full_nwp_weight < 0:
            raise ValueError("timestep_start_full_nwp_weight cannot be smaller than zero")
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a DeviceMesh (parallel.make_mesh)")
        device = resolve_device(device, precip, precip_models, velocity, velocity_models)
        if mesh is not None and mesh.device_type != device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot run a forecast on {device}")
    t0 = time.perf_counter()
    with annotate("pst.init"):
        if precip_thr is None:
            raise ValueError("precip_thr required")
        int_steps, subsel = _leads(timesteps)
        if (timestep_start_full_nwp_weight is not None
                and timestep_start_full_nwp_weight >= int_steps):
            raise ValueError(
                "timestep_start_full_nwp_weight cannot be the same or larger "
                "than the total number of timesteps in this forecast"
            )

        inputs = scan_inputs(
            precip, precip_models, velocity, velocity_models, timesteps, timestep,
            n_ens_members=n_ens_members, n_cascade_levels=n_cascade_levels,
            blend_nwp_members=blend_nwp_members, precip_thr=precip_thr, norain_thr=norain_thr,
            kmperpixel=kmperpixel, bandpass_filter_method=bandpass_filter_method,
            noise_method=noise_method, noise_stddev_adj=noise_stddev_adj, ar_order=ar_order,
            vel_pert_method=vel_pert_method, weights_method=weights_method,
            conditional=conditional, probmatching_method=probmatching_method,
            mask_method=mask_method, resample_distribution=resample_distribution,
            smooth_radar_mask_range=smooth_radar_mask_range, seed=seed,
            outdir_path_skill=outdir_path_skill, extrap_kwargs=extrap_kwargs,
            filter_kwargs=filter_kwargs, noise_kwargs=noise_kwargs,
            vel_pert_kwargs=vel_pert_kwargs, clim_kwargs=clim_kwargs, mask_kwargs=mask_kwargs,
            precip_nowcast=precip_nowcast,
            timestep_start_full_nwp_weight=timestep_start_full_nwp_weight, device=device,
        )
        if inputs is None:
            return nowcast_utils.zero_precipitation_forecast(
                n_ens_members, timesteps, nowcast_utils.to_numpy(precip), device, callback,
                return_output, measure_time, t0,
            )
        params, state, statics = inputs.params, inputs.state, inputs.statics
        E = n_ens_members
        m, n = state.cascades.shape[-2:]
        spatial = mesh is not None and axis_size(mesh, "y") > 1
        block = None
        if mesh is not None and not spatial:
            ens = axis_size(mesh, "ens")
            block = member_block(E, mesh) if ens > 1 and E % ens == 0 else None
        sorts = None
        if probmatching_method == "cdf" and resample_distribution and not spatial:
            with annotate("pst.init.presort"):
                sorts = _presort_targets(params.precip_last, params.nwp_fields,
                                         params.precip_min)
        if measure_time:
            _sync(device)
    init_time = time.perf_counter() - t0
    t1 = time.perf_counter()
    with annotate("pst.loop"):
        if callback is not None and not return_output and subsel is None and block is None \
                and not spatial:
            # the streaming contract: chunks of at most 4 leads reach the
            # callback and leave the device
            _blending_scan(params, state, int_steps, sorts=sorts, callback=callback,
                           out_dtype=output_dtype, **statics)
            if measure_time:
                _sync(device)
                return None, init_time, time.perf_counter() - t1
            return None

        if spatial:
            from pysteps_tpu_torch.parallel.sharded_blending import blending_scan_sharded

            out = blending_scan_sharded(params, state, int_steps, mesh,
                                        vmax_bound=inputs.vmax_bound, **statics)
            out = out.to(getattr(torch, output_dtype))
        elif block is not None:
            # this rank's members, on every member's draws
            out = _blending_scan(params, state, int_steps, members=slice(*block),
                                 draw_all=True, sorts=sorts, out_dtype=output_dtype, **statics)
            out = all_gather_cat(out, mesh, "ens", dim=0)
        else:
            out = torch.empty((E, int_steps, m, n), dtype=getattr(torch, output_dtype),
                              device=device)
            chunk = (member_chunk if member_chunk and E % member_chunk == 0 and subsel is None
                     else E)
            for c0 in range(0, E, chunk):
                _blending_scan(params, state, int_steps, members=slice(c0, c0 + chunk),
                               sorts=sorts, out=out[c0: c0 + chunk], **statics)
        if measure_time:
            _sync(device)
    loop_time = time.perf_counter() - t1

    if subsel is not None:
        with annotate("pst.write"):
            out = nowcast_utils.interpolate_leads(out, subsel, axis=1)
    if callback is not None:
        with annotate("pst.stream"):
            nowcast_utils.stream_leads(out, out.shape[1], callback)
    result = out if return_output else None
    if measure_time:
        return result, init_time, loop_time
    return result
