"""
Reduced-space PCA ensemble-Kalman-filter combination of radar and NWP on
PyTorch (counterpart of ``pysteps_tpu/blending/pca_ens_kalman_filter.py``;
Nerini et al. 2019).

Every lead advances each member one nowcast step from the previous
analysis; whenever an NWP field is valid the PCA-reduced EnKF correction
(``ens_kalman_filter_methods.masked_enkf_correct_core``) replaces the
prediction before the next step, so corrections feed back into the AR and
advection state.  The members advance together (JAX vmaps over them) in a
Python loop over leads (JAX: ``lax.scan``); the filter's scalars ride
along as 0-d tensors, and the full-NWP switch is one host read a cycle
(JAX: ``lax.cond``).

The velocity is not perturbed, so one displacement serves every member.
On a CUDA device of at least 144 px a side the advection takes the JAX
package's TPU branch, the static bound 48 (the velocity sampled through
kernel K1 on the 4x coarse grid, the fields warped by K1's shift
decomposition, all members in one launch an axis); on the CPU the exact
gather.  Randomness (the noise pool, the members' picks from it, the
resampled targets) comes from one ``torch.Generator`` seeded from
``seed``; the draws differ from the JAX package's, their law does not.
``mesh`` reaches ``MaskedEnKF`` through the combination kwargs, as in the
JAX package (its class API shards the PCA fit); the combination loop runs
replicated on every rank.
"""

import dataclasses
import datetime
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from pysteps_tpu_torch import cascade, noise
from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.blending.ens_kalman_filter_methods import (
    EnsembleKalmanFilter,
    MaskedEnKF,
    masked_enkf_correct_core,
)
from pysteps_tpu_torch.blending.steps import _match_cdf_targets
from pysteps_tpu_torch.cascade.decomposition import decompose_core
from pysteps_tpu_torch.extrapolation.semilagrangian import integrate_displacement
from pysteps_tpu_torch.noise import fftgenerators
from pysteps_tpu_torch.nowcasts import utils as nowcast_utils
from pysteps_tpu_torch.nowcasts.steps import _lagrangian_alignment
from pysteps_tpu_torch.ops.conv import pool_same, sep_corr
from pysteps_tpu_torch.ops.warp import warp, warp_shifted_multi
from pysteps_tpu_torch.timeseries import autoregression, correlation
from pysteps_tpu_torch.utils import tapering as tapering_utils
from pysteps_tpu_torch.utils.check_norain import check_norain

# the static displacement bound of the card's path, and the smallest side
# that takes it
_MAX_DISP = 48


@dataclasses.dataclass(frozen=True)
class EnKFCombinationConfig:
    """Configuration (reference: pca_ens_kalman_filter.py:82)."""

    n_ens_members: int = 24
    n_cascade_levels: int = 6
    precip_threshold: float = -10.0
    norain_threshold: float = 0.01
    enkf_method: str = "masked_enkf"
    enable_combination: bool = True
    ar_order: int = 1
    seed: Optional[int] = None
    combination_kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EnKFCombinationParams:
    """Quantities shared by the forecast and the correction."""

    combination_kwargs: dict = dataclasses.field(default_factory=dict)
    zerovalue: float = 0.0
    n_nwp_members: int = 0
    n_timesteps: int = 0


@dataclasses.dataclass
class ForecastState:
    """State of the combination loop."""

    analysis: torch.Tensor               # (E, m, n) current combined ensemble
    generator: torch.Generator           # the resampling draws
    timestep: int = 0


class ForecastInitialization:
    """Background-ensemble generation: the cycling nowcaster with the
    combination disabled (the reference architecture's class)."""

    def __init__(self, obs_precip, velocity, config, forecast_horizon, **kwargs):
        self.obs_precip = nowcast_utils.to_numpy(obs_precip).astype(np.float32)
        self.velocity = velocity
        self.config = config
        self.forecast_horizon = forecast_horizon
        self.kwargs = kwargs

    def compute_background(self):
        """Stochastic nowcast over the horizon: (E, T, m, n) without the t0
        analysis, NaN as the observed minimum."""
        cfg = dataclasses.replace(self.config, enable_combination=False)
        nwp = np.broadcast_to(
            self.obs_precip[-1],
            (1, int(self.forecast_horizon) + 1) + self.obs_precip.shape[1:],
        )
        out = EnKFCombinationNowcaster(
            self.obs_precip, nwp, self.velocity, self.forecast_horizon,
            enkf_combination_config=cfg, **self.kwargs,
        ).compute_forecast()
        return torch.nan_to_num(out[:, 1:], nan=float(np.nanmin(self.obs_precip)))


class ForecastModel:
    """One combination cycle's correction by the (masked) EnKF class; the
    forecast step is a passthrough (the nowcaster's loop does the
    per-member work)."""

    def __init__(self, config, params, enkf):
        self.config = config
        self.params = params
        self.enkf = enkf

    def correction_step(self, state, background_t, nwp_t, horizon):
        analysis, _ = self.enkf.correct_step(
            background_t, nwp_t, resampled_forecast=torch.as_tensor(background_t).clone(),
            generator=state.generator,
        )
        return ForecastState(analysis=analysis, generator=state.generator,
                             timestep=state.timestep + 1)

    def forecast_step(self, state, background_t):
        return ForecastState(analysis=background_t, generator=state.generator,
                             timestep=state.timestep + 1)


def _square_dilate(mask, size):
    """Binary dilation of (..., m, n) with a size x size square, as float."""
    if size <= 1:
        return mask.to(torch.float32)
    return pool_same(mask.to(torch.float32), size, "max")


def _gauss1(img):
    """Zero-padded separable Gaussian blur with sigma 1, radius 4."""
    x = np.arange(-4, 5, dtype=np.float64)
    k = np.exp(-0.5 * x**2)
    k = torch.as_tensor(k / k.sum(), dtype=torch.float32, device=img.device)
    return sep_corr(img, k, k)


def _forecast_core(
    nwc, cascades, mu, sigma, generator, nwp_mapped, fc_resampled, weights_2d, phi, nsc,
    res_mask, noise_pool, velocity, domain_mask, precip_thr, fillval, is_corr, dil,
    max_disp, idx=None,
):
    """One nowcast cycle of all members (reference:
    ForecastModel.run_forecast_step, pca_ens_kalman_filter.py:670-712):
    decompose the current (possibly corrected) prediction into the latest
    cascade lag, update the precipitation mask from the NWP and the own
    forecast, AR-iterate with noise from the pool, recompose, match the
    CDF to the resampled target and advect one step.  ``idx`` (E,), each
    member's pick from the pool, comes from ``generator`` unless given.
    Returns (nwc, cascades, mu, sigma)."""
    E, m, n = nwc.shape
    n_pool = noise_pool.shape[0]

    # one unit advection step a cycle (the reference integrates from zero
    # at every call)
    disp = integrate_displacement(velocity, torch.zeros_like(velocity), 1.0, n_iter=1,
                                  max_disp=max_disp)

    levels, means, stds = decompose_core(nwc, weights_2d, normalize=True)  # (E, k, m, n)
    cascades = torch.cat([cascades[:, :, :-1], levels[:, :, None]], dim=2)
    if is_corr:
        # correction cycles refresh the scaling: the means of the analysis,
        # sigma by the AR(1) law, the scales above the NWP's effective
        # resolution the analysis' stds
        mu = means
        sig_ar = torch.sqrt(phi[:, 0] ** 2 * sigma**2 + phi[:, -1] ** 2 * nsc**2)
        sigma = torch.where(res_mask, stds, sig_ar)

    # the union of the dilated NWP and own rain areas, smoothed, outside
    # the radar domain zero
    pm = _square_dilate(nwp_mapped > precip_thr, dil) + _square_dilate(nwc > precip_thr, dil)
    pm = _gauss1(torch.clamp(pm, 0.0, 1.0))
    pm = torch.where(domain_mask, 0.0, pm) > 0.0

    if idx is None:
        idx = _pool_picks(generator, n_pool, E)
    eps = noise_pool[idx.to(noise_pool.device)] * pm[:, None].to(torch.float32) \
        * nsc[:, None, None]
    cascades = autoregression.iterate_ar_model(cascades, phi, eps=eps)

    field = torch.sum(cascades[:, :, -1] * sigma[..., None, None] + mu[..., None, None], dim=1)
    field = _match_cdf_targets(field, fc_resampled.reshape(E, -1))

    if max_disp is not None:
        out = warp_shifted_multi(field, disp, max_disp, cval=float("nan"))
    else:
        out = warp(field, disp.expand(E, 2, m, n), order=1, cval=float("nan"))
    out = torch.where(torch.isnan(out), fillval, out)
    return out, cascades, mu, sigma


def _pool_picks(generator, n_pool, E):
    """Each member's pick from the noise pool (a replaceable function, so
    that a test can hand in another library's draws)."""
    return torch.randint(0, n_pool, (E,), generator=generator, device=generator.device)


def _cycle_core(carry, t_corr, t_now, nwp_mapped, weights_2d, phi, nsc, res_mask,
                noise_pool, velocity, domain_mask, taper_enkf, w_model, precip_thr, fillval,
                is_corr, dil, max_disp, obs_norain, corr_cfg, has_smooth):
    """One combination cycle: the EnKF correction when scheduled, the
    nowcast step, the full-NWP-weight switch and the output field.
    ``carry`` is (nwc, cascades, mu, sigma, generator, fc_resampled,
    samp_prob, accum_prob, infl_obs_tmp, degrade_t).  Returns (carry,
    output (E, m, n), whether the cycle took the full NWP)."""
    (nwc, cascades, mu, sigma, gen, fc_res, sp, ap, it, dt) = carry
    # an index past the NWP stack takes its last field (JAX's dynamic index
    # clamps)
    last = nwp_mapped.shape[1] - 1
    nwp_corr = nwp_mapped[:, min(t_corr, last)]
    nwp_now = nwp_mapped[:, min(t_now, last)]
    full_nwp = bool(it <= 0.02) or obs_norain
    if full_nwp:
        nwc = nwp_now
    else:
        if is_corr:
            nwc, fc_res, sp, ap, it, dt = masked_enkf_correct_core(
                nwc, nwp_corr, fc_res, gen, sp, ap, it, dt, taper=taper_enkf, **corr_cfg)
        nwc, cascades, mu, sigma = _forecast_core(
            nwc, cascades, mu, sigma, gen, nwp_corr, fc_res, weights_2d, phi, nsc, res_mask,
            noise_pool, velocity, domain_mask, precip_thr, fillval, is_corr, dil, max_disp)
    nwp_sel = nwp_now if full_nwp else nwp_corr
    if has_smooth:
        out_field = w_model * torch.nan_to_num(nwp_sel) + (1.0 - w_model) * torch.nan_to_num(nwc)
    else:
        out_field = torch.where(domain_mask, float("nan"), nwc)
    return (nwc, cascades, mu, sigma, gen, fc_res, sp, ap, it, dt), out_field, full_nwp


def _cycle(carry, nwp_mapped, t_corr, t_now, *consts, **statics):
    """One cycle with the JAX package's argument order (``consts``:
    weights_2d, phi, nsc, res_mask, noise_pool, velocity, domain_mask,
    taper_enkf, w_model, precip_thr, fillval; ``statics``: is_corr, dil,
    max_disp, obs_norain, corr_cfg, has_smooth)."""
    return _cycle_core(carry, t_corr, t_now, nwp_mapped, *consts, **statics)


def _cycle_scan(carry, nwp_mapped, t_corrs, t_nows, *consts, **statics):
    """A run of cycles with the same static flags over the (t_corr, t_now)
    schedule (JAX: one ``lax.scan``); returns (carry, outputs (n, E, m,
    n))."""
    outs = []
    for tc, tn in zip(t_corrs, t_nows):
        carry, out_field, _ = _cycle_core(carry, int(tc), int(tn), nwp_mapped, *consts,
                                          **statics)
        outs.append(out_field)
    return carry, torch.stack(outs)


def _fit_ar(cascades0, ar_order, norain):
    """Per-level temporal autocorrelation and Yule-Walker fit of the
    (k, p+1, m, n) cascades, batched over the levels."""
    k_levels = cascades0.shape[0]
    if norain:
        gamma = torch.ones((k_levels, ar_order), device=cascades0.device)
    else:
        gamma = torch.stack([
            torch.stack(correlation.temporal_autocorrelation(xs)) for xs in cascades0])
    if ar_order == 2:
        g2 = autoregression.adjust_lag2_corrcoef2(gamma[:, 0], gamma[:, 1])
        gamma = torch.stack([gamma[:, 0], g2], dim=1)
    return autoregression.estimate_ar_params_yw(gamma, check_stationarity=False)


def _prep_nwp(x, member_map, thr, fillval):
    """NaN fill, threshold and member mapping of the (n_nwp, T, m, n) NWP
    stack: (E, T, m, n)."""
    x = torch.where(torch.isfinite(x), x, fillval)
    x = torch.where(x < thr, fillval, x)
    return x.index_select(0, member_map)


def _init_noise_pool(generator, filt, shape, use_full_fft, weights_2d, n_pool, k_levels):
    """The pool of ``n_pool`` normalized noise cascades (n_pool, k, m, n)
    (reference: __initialize_noise_field_pool, :528-583)."""
    del k_levels
    eps = fftgenerators._generate_fft_noise(generator, filt, shape, n_pool, domain="spatial",
                                            standardize=True, use_full_fft=use_full_fft)
    levels, _, _ = decompose_core(eps, weights_2d, normalize=True)
    return levels


def _max_disp(device, shape):
    """The static displacement bound of the advection: 48 on a CUDA device
    for grids of at least 3 x 48 px a side (the JAX package's TPU
    branch), else None (the exact gather)."""
    if device.type == "cpu" or min(shape) < 3 * _MAX_DISP:
        return None
    return _MAX_DISP


class EnKFCombinationNowcaster:
    """Forecast/correction cycling (reference:
    pca_ens_kalman_filter.py:923-1553).  After :meth:`compute_forecast`,
    ``full_nwp_leads`` lists the leads (minutes) that took the NWP ensemble
    as they are, with no nowcast step."""

    def __init__(self, obs_precip, nwp_precip, velocity, forecast_horizon,
                 enkf_combination_config, noise_method="nonparametric",
                 noise_stddev_adj=None, timestep=5, kmperpixel=1.0,
                 callback=None, return_output=True, measure_time=False,
                 nowcast_kwargs=None, verbose_output=False,
                 obs_timestamps=None, nwp_timestamps=None, issuetime=None,
                 precip_mask_dilation=1, n_noise_fields=30,
                 smooth_radar_mask_range=0, mesh=None, device=None):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a DeviceMesh (parallel.make_mesh)")
        self.device = resolve_device(device, obs_precip, nwp_precip, velocity)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot run a forecast on {self.device}")
        self.mesh = mesh
        self.obs_precip = nowcast_utils.to_numpy(obs_precip).astype(np.float32)
        # an NWP stack already on the device stays there
        if isinstance(nwp_precip, torch.Tensor):
            self.nwp_precip = nwp_precip.to(self.device, torch.float32)
        else:
            self.nwp_precip = torch.tensor(np.asarray(nwp_precip, np.float32),
                                           device=self.device)
        if self.nwp_precip.ndim == 3:
            self.nwp_precip = self.nwp_precip[None]
        self.velocity = nowcast_utils.to_numpy(velocity).astype(np.float32)
        self.forecast_horizon = forecast_horizon
        self.config = enkf_combination_config
        self.noise_method = noise_method
        self.noise_stddev_adj = noise_stddev_adj
        self.timestep = timestep
        self.kmperpixel = kmperpixel
        self.callback = callback
        self.return_output = return_output
        self.measure_time = measure_time
        self.nowcast_kwargs = dict(nowcast_kwargs or {})
        self.verbose_output = verbose_output
        self.obs_timestamps = obs_timestamps
        self.nwp_timestamps = nwp_timestamps
        self.issuetime = issuetime
        self.precip_mask_dilation = int(precip_mask_dilation)
        self.n_noise_fields = int(n_noise_fields)
        self.smooth_radar_mask_range = smooth_radar_mask_range
        self.full_nwp_leads = []

    def _resolve_leadtimes(self):
        """Temporal resolution and forecast/correction lead-time arrays from
        the timestamps (reference: __check_input_timestamps, :1202-1284).
        Without timestamps, ``forecast_horizon`` counts steps of
        ``timestep`` and every step is a correction step."""
        if self.obs_timestamps is not None and len(self.obs_timestamps) > 1:
            diffs = np.unique(np.diff(np.asarray(self.obs_timestamps)))
            if diffs.size > 1:
                raise ValueError(
                    "Observation data has a different temporal resolution "
                    "or observations are missing!"
                )
            res = int(diffs[0].total_seconds() / 60)
            fc_init = self.obs_timestamps[-1]
            if self.issuetime is not None and fc_init != self.issuetime:
                raise ValueError("The last observation timestamp differs from forecast issue time!")
            horizon_min = int(self.forecast_horizon)
        else:
            res = int(self.timestep) if self.timestep else 5
            fc_init = self.issuetime
            horizon_min = int(self.forecast_horizon) * res
        leadtimes = np.arange(0, horizon_min + 1, res)
        if self.nwp_timestamps is not None and fc_init is not None:
            nwp_ts = np.asarray(self.nwp_timestamps)
            keep = (nwp_ts >= fc_init) & (
                nwp_ts <= fc_init + datetime.timedelta(minutes=horizon_min))
            if not keep.any() or nwp_ts[0] > fc_init:
                raise ValueError("Forecast issue time is not included in the NWP forecast!")
            kidx = np.nonzero(keep)[0]
            self.nwp_precip = self.nwp_precip[:, kidx[0]: kidx[-1] + 1]
            correction_leadtimes = np.array(
                [int((t - fc_init).total_seconds() / 60) for t in nwp_ts[keep]])
        else:
            correction_leadtimes = leadtimes.copy()
            self.nwp_precip = self.nwp_precip[:, : leadtimes.size]
        return leadtimes, correction_leadtimes

    def compute_forecast(self):
        cfg = self.config
        dev = self.device
        t0 = time.perf_counter()
        leadtimes, corr_leadtimes = self._resolve_leadtimes()
        n_steps = leadtimes.size

        obs_norain = check_norain(self.obs_precip, cfg.precip_threshold,
                                  cfg.norain_threshold, None, printmsg=False)
        # the rain fraction of the NWP stack on its device
        rain_frac = float((self.nwp_precip > cfg.precip_threshold).to(torch.float32).mean())
        nwp_norain = rain_frac <= cfg.norain_threshold
        if obs_norain and nwp_norain:
            return nowcast_utils.zero_precipitation_forecast(
                cfg.n_ens_members, n_steps - 1, self.obs_precip, dev, self.callback,
                self.return_output, self.measure_time, t0)

        E = cfg.n_ens_members
        p = cfg.ar_order
        m, n = self.obs_precip.shape[1:]
        k_levels = cfg.n_cascade_levels
        thr = float(cfg.precip_threshold)
        fillval = thr - 2.0
        n_nwp = self.nwp_precip.shape[0]
        params = EnKFCombinationParams(
            combination_kwargs=dict(cfg.combination_kwargs),
            zerovalue=float(np.nanmin(self.obs_precip)),
            n_nwp_members=n_nwp,
            n_timesteps=self.nwp_precip.shape[1],
        )
        if self.mesh is not None:
            params.combination_kwargs.setdefault("mesh", self.mesh)
        enkf = (MaskedEnKF(cfg, params) if cfg.enkf_method == "masked_enkf"
                else EnsembleKalmanFilter(cfg, params))

        # initialization
        obs = self.obs_precip[-(p + 1):].copy()
        domain_mask = np.logical_or.reduce([~np.isfinite(obs[i]) for i in range(obs.shape[0])])
        velocity = torch.as_tensor(self.velocity, device=dev)
        obs_t = torch.as_tensor(np.nan_to_num(obs, nan=fillval), device=dev)
        obs_aligned = _lagrangian_alignment(obs_t, velocity)
        obs_aligned = torch.where(obs_aligned < thr, fillval, obs_aligned)

        bp_filter = cascade.get_method("gaussian")((m, n), k_levels)
        weights_2d = torch.tensor(np.asarray(bp_filter["weights_2d"]), dtype=torch.float32,
                                     device=dev)
        central_wn = np.asarray(
            bp_filter.get("central_wavenumbers")
            if bp_filter.get("central_wavenumbers") is not None
            else bp_filter["central_freqs"] * max(m, n))
        nwp_hres_eff = params.combination_kwargs.get("nwp_hres_eff", 0.0)
        res_mask = torch.as_tensor(m / np.maximum(central_wn, 1e-12) >= nwp_hres_eff * 3.0,
                                   device=dev)

        levels, means, stds = decompose_core(obs_aligned, weights_2d, normalize=True)
        cascades0 = levels.transpose(0, 1)  # (k, p+1, m, n)
        phi = _fit_ar(cascades0, p, bool(obs_norain)).to(torch.float32)

        # the noise filter, std coefficients and pool
        taper = torch.as_tensor(tapering_utils.compute_window_function(m, n, "tukey"),
                                dtype=torch.float32, device=dev)
        filt = fftgenerators.nonparam_filter_core(obs_aligned, taper)
        if self.noise_stddev_adj == "fixed":
            nsc = torch.tensor([1.0 / (0.75 + 0.09 * k) for k in range(1, k_levels + 1)],
                               dtype=torch.float32, device=dev)
        elif self.noise_stddev_adj == "auto":
            gen_adj = torch.Generator(device=dev)
            gen_adj.manual_seed((cfg.seed or 42) + 1)
            nsc = noise.utils.compute_noise_stddev_adjs(
                obs_t[-1], thr, float(params.zerovalue), bp_filter, None,
                {"field": filt, "input_shape": (m, n), "use_full_fft": False}, None, 20,
                conditional=True, generator=gen_adj).to(torch.float32)
        else:
            nsc = torch.ones(k_levels, dtype=torch.float32, device=dev)

        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed if cfg.seed is not None else 42)
        noise_pool = _init_noise_pool(generator, filt, (m, n), False, weights_2d,
                                      self.n_noise_fields, k_levels)

        # the state
        latest = torch.as_tensor(np.nan_to_num(obs[-1], nan=fillval), device=dev)
        nwc = latest.expand(E, m, n)
        fc_resampled = nwc
        cascades = cascades0[None, :, -p:].expand(E, k_levels, p, m, n)
        mu = means[-1].expand(E, k_levels)
        sigma = stds[-1].expand(E, k_levels)
        domain_mask_t = torch.as_tensor(domain_mask, device=dev)

        # the member-mapped NWP stack, prepared once
        member_map = torch.arange(E, device=dev) % n_nwp
        nwp_mapped = _prep_nwp(self.nwp_precip, member_map, thr, fillval)
        max_disp = _max_disp(dev, (m, n))

        has_smooth = bool(self.smooth_radar_mask_range)
        if has_smooth:
            from pysteps_tpu_torch.blending.utils import compute_smooth_dilated_mask

            w_model = torch.clamp(torch.nan_to_num(compute_smooth_dilated_mask(
                domain_mask_t, max_padding_size_in_px=int(self.smooth_radar_mask_range))),
                0.0, 1.0)
        else:
            w_model = torch.zeros((1, 1), dtype=torch.float32, device=dev)

        corr_cfg = {
            "precip_thr": thr,
            "norain_thr": float(cfg.norain_threshold),
            "n_ens_prec": int(getattr(enkf, "_n_ens_prec", 1)),
            "n_lien": int(getattr(enkf, "_n_lien", E // 2)),
            "non_precip_mask": bool(getattr(enkf, "_non_precip_mask", True)),
            "lien_criterion": bool(getattr(enkf, "_lien_criterion", True)),
            "inflation_factor_bg": float(getattr(enkf, "_inflation_factor_bg", 1.0)),
            "inflation_factor_obs": float(getattr(enkf, "_inflation_factor_obs", 1.0)),
            "offset_bg": float(getattr(enkf, "_offset_bg", 0.0)),
            "offset_obs": float(getattr(enkf, "_offset_obs", 0.0)),
            "iterative_prob_matching": bool(getattr(enkf, "_iterative_prob_matching", True)),
            "sampling_prob_source": str(getattr(enkf, "_sampling_prob_source", "ensemble")),
            "use_accum": bool(getattr(enkf, "_use_accum_sampling_prob", False)),
            "ensure_full_nwp_weight": bool(getattr(enkf, "_ensure_full_nwp_weight", True)),
        }
        taper_enkf = torch.as_tensor(enkf.get_tapering(2 * E), dtype=torch.float32, device=dev)

        def scalar(v):
            return torch.tensor(float(v), dtype=torch.float32, device=dev)

        carry = (nwc, cascades, mu, sigma, generator, fc_resampled, scalar(0.0), scalar(0.0),
                 scalar(getattr(enkf, "_inflation_factor_obs_tmp", 1.0)),
                 scalar(getattr(enkf, "_degradation_timestep", 0.2)))
        consts = (weights_2d, phi, nsc, res_mask, noise_pool, velocity, domain_mask_t,
                  taper_enkf, w_model, thr, fillval)
        statics = dict(dil=self.precip_mask_dilation, max_disp=max_disp,
                       obs_norain=bool(obs_norain), corr_cfg=corr_cfg, has_smooth=has_smooth)

        def btf0(fields, nwp_t):
            if has_smooth:
                return w_model * torch.nan_to_num(nwp_t) + (1.0 - w_model) * torch.nan_to_num(fields)
            return torch.where(domain_mask_t, float("nan"), fields)

        outputs = [btf0(nwc, nwp_mapped[:, 0])] if self.return_output else []
        if self.device.type == "cuda":
            torch.cuda.synchronize(dev)
        init_time = time.perf_counter() - t0
        t_loop0 = time.perf_counter()

        # the schedule: each step's correction flag and NWP indices
        t_corr = 0
        self.full_nwp_leads = []
        for t in range(1, n_steps):
            is_corr = bool(leadtimes[t - 1] in corr_leadtimes and t > 1
                           and cfg.enable_combination and not nwp_norain)
            if leadtimes[t] in corr_leadtimes:
                t_now = int(np.where(corr_leadtimes == leadtimes[t])[0][0])
            else:
                t_now = t_corr
            if is_corr:
                t_corr = int(np.where(corr_leadtimes == leadtimes[t - 1])[0][0])
            carry, out_field, took_full = _cycle(
                carry, nwp_mapped, t_corr, t_now, *consts, is_corr=is_corr, **statics)
            if took_full:
                self.full_nwp_leads.append(int(leadtimes[t]))
                if self.verbose_output:
                    print(f"Full NWP weight is reached for lead time + {leadtimes[t]} min")
            if self.callback is not None and not took_full:
                self.callback(out_field.cpu().numpy())
            if self.return_output:
                outputs.append(out_field)

        result = torch.stack(outputs, dim=1) if self.return_output else None
        if self.device.type == "cuda":
            torch.cuda.synchronize(dev)
        if self.measure_time:
            return result, init_time, time.perf_counter() - t_loop0
        return result


def forecast(
    obs_precip,
    obs_timestamps,
    nwp_precip,
    nwp_timestamps,
    velocity,
    forecast_horizon,
    issuetime=None,
    n_ens_members=24,
    precip_mask_dilation=1,
    smooth_radar_mask_range=0,
    n_cascade_levels=6,
    precip_thr=-10.0,
    norain_thr=0.01,
    extrap_method="semilagrangian",
    decomp_method="fft",
    bandpass_filter_method="gaussian",
    noise_method="nonparametric",
    enkf_method="masked_enkf",
    enable_combination=True,
    noise_stddev_adj=None,
    ar_order=1,
    callback=None,
    return_output=True,
    seed=None,
    num_workers=1,
    fft_method="numpy",
    domain="spatial",
    timestep=5,
    kmperpixel=1.0,
    combination_kwargs=None,
    extrap_kwargs=None,
    filter_kwargs=None,
    noise_kwargs=None,
    verbose_output=False,
    measure_time=False,
    device=None,
    **kwargs,
):
    """PCA EnKF combined forecast with the JAX package's signature plus
    ``device`` (CUDA unless the caller asks for the CPU or passes CPU
    tensors; ``RuntimeError`` when CUDA is needed and absent).

    obs_precip: (ar_order+1, m, n) radar inputs; nwp_precip: (n_nwp_ens,
    T, m, n) NWP ensemble fields valid at the forecast steps;
    forecast_horizon: minutes with timestamps, else steps.  Returns an
    (n_ens_members, T, m, n) tensor, the analysis at t0 first."""
    config = EnKFCombinationConfig(
        n_ens_members=n_ens_members,
        n_cascade_levels=n_cascade_levels,
        precip_threshold=precip_thr,
        norain_threshold=norain_thr,
        enkf_method=enkf_method,
        enable_combination=enable_combination,
        ar_order=ar_order,
        seed=seed,
        combination_kwargs=dict(combination_kwargs or {}),
    )
    nowcast_kwargs = {}
    if extrap_kwargs:
        nowcast_kwargs["extrap_kwargs"] = dict(extrap_kwargs)
    if filter_kwargs:
        nowcast_kwargs["filter_kwargs"] = dict(filter_kwargs)
    if noise_kwargs:
        nowcast_kwargs["noise_kwargs"] = dict(noise_kwargs)
    nowcaster = EnKFCombinationNowcaster(
        obs_precip, nwp_precip, velocity, forecast_horizon,
        enkf_combination_config=config,
        noise_method=noise_method,
        noise_stddev_adj=noise_stddev_adj,
        timestep=timestep,
        kmperpixel=kmperpixel,
        callback=callback,
        return_output=return_output,
        measure_time=measure_time,
        nowcast_kwargs=nowcast_kwargs,
        verbose_output=verbose_output,
        obs_timestamps=obs_timestamps,
        nwp_timestamps=nwp_timestamps,
        issuetime=issuetime,
        precip_mask_dilation=precip_mask_dilation,
        n_noise_fields=kwargs.get("n_noise_fields", 30),
        smooth_radar_mask_range=smooth_radar_mask_range,
        mesh=kwargs.get("mesh"),
        device=device,
    )
    return nowcaster.compute_forecast()
