"""
STEPS stochastic ensemble nowcast on PyTorch (counterpart of
``pysteps_tpu/nowcasts/steps.py``).

The JAX package's design carries over with PyTorch idiom:

- the ensemble is a leading member axis of every tensor of the scan (JAX
  vmaps over members), so each kernel launch serves all members of a
  member chunk;
- the lead-time loop is a Python loop (JAX: ``lax.scan``);
- randomness comes from one explicit ``torch.Generator`` (JAX: per-member
  ``fold_in`` key chains); the draws differ from the JAX package's, their
  law does not;
- the device is explicit.  On CUDA tensors the scan takes the path the JAX
  package takes on the TPU: static displacement bounds, the 4x coarse
  displacement carry, the PWL matcher and the hand-written kernels
  (``ops/``), with the fused match-rim-warp chain where
  :func:`_chain_available` allows it.  On CPU tensors it takes the JAX
  package's CPU path: the exact-gather warp and the sort matcher.  The
  internal functions take ``max_disp``, the matcher choice and
  ``use_chain`` as explicit arguments, so any path can be driven on
  either device.

Every noise method of the JAX package runs (nonparametric, parametric,
ssft, nested, or none) with either ``noise_stddev_adj`` ("auto",
"fixed"); the filters are built on the forecast's device.  The callback
gets each lead's frames as host numpy arrays; with ``return_output=False``
they stream in chunks of at most 6 leads and the forecast returns None.

With ``mesh`` (a ``parallel.make_mesh`` mesh; every rank calls the forecast
with the same inputs) the members split over the mesh's "ens" dimension
when it has more than one rank and divides the member count, as the JAX
package's ``_steps_scan_ens_sharded`` splits them; otherwise the forecast
is the unsharded one.  A rank draws the noise of every member from the one
generator and keeps its own members' draws, so the sharded forecast equals
the unsharded one; one all-gather over "ens" returns every member to every
rank.
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from pysteps_tpu_torch import cascade, noise
from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.cascade.decomposition import (
    decompose_core,
    decompose_spectral_core,
    recompose_core,
    recompose_spectral_core,
)
from pysteps_tpu_torch.extrapolation.semilagrangian import (
    coarsen_velocity,
    integrate_displacement,
    integrate_displacement_coarse,
    model_warp,
    model_warp_coarse,
    upsample_planes,
)
from pysteps_tpu_torch.noise import fftgenerators
from pysteps_tpu_torch.noise.motion import (
    _laplace,
    get_default_params_bps_par,
    get_default_params_bps_perp,
)
from pysteps_tpu_torch.nowcasts import utils as nowcast_utils
from pysteps_tpu_torch.ops import pallas_chain, pallas_histmatch
from pysteps_tpu_torch.parallel.mesh import all_gather_cat, axis_size, member_block
from pysteps_tpu_torch.postprocessing.probmatching import prepare_cdf_matcher
from pysteps_tpu_torch.timeseries import autoregression, correlation
from pysteps_tpu_torch.utils import tapering as tapering_utils
from pysteps_tpu_torch.utils.check_norain import check_norain
from pysteps_tpu_torch.utils.profiling import annotate

# static displacement bound (pixels) of the kernel path: grids of at least
# 3 * _MAX_DISP pixels a side use it for every storm
_MAX_DISP = 48
_NOISE_METHODS = (None, "nonparametric", "parametric", "ssft", "nested")


@dataclasses.dataclass(frozen=True)
class StepsNowcasterConfig:
    """Configuration of a STEPS run (the JAX package's fields)."""

    n_ens_members: int = 24
    n_cascade_levels: int = 6
    precip_threshold: Optional[float] = None
    norain_threshold: float = 0.0
    kmperpixel: Optional[float] = None
    timestep: Optional[float] = None
    extrapolation_method: str = "semilagrangian"
    decomposition_method: str = "fft"
    bandpass_filter_method: str = "gaussian"
    noise_method: Optional[str] = "nonparametric"
    noise_stddev_adj: Optional[str] = None
    ar_order: int = 2
    velocity_perturbation_method: Optional[str] = "bps"
    conditional: bool = False
    probmatching_method: Optional[str] = "cdf"
    mask_method: Optional[str] = "incremental"
    seed: Optional[int] = None
    num_workers: int = 1
    fft_method: str = "numpy"
    domain: str = "spatial"
    extrapolation_kwargs: dict = dataclasses.field(default_factory=dict)
    filter_kwargs: dict = dataclasses.field(default_factory=dict)
    noise_kwargs: dict = dataclasses.field(default_factory=dict)
    velocity_perturbation_kwargs: dict = dataclasses.field(default_factory=dict)
    mask_kwargs: dict = dataclasses.field(default_factory=dict)
    measure_time: bool = False
    callback: Optional[callable] = None
    return_output: bool = True
    member_chunk: Optional[int] = None
    mesh: Optional[object] = None
    output_dtype: str = "float32"


@dataclasses.dataclass
class StepsNowcasterParams:
    """Quantities derived at initialization and fixed over the loop."""

    phi: torch.Tensor            # (k, p+1) AR parameters per cascade level
    gamma: torch.Tensor          # (k, p) temporal autocorrelations
    means: torch.Tensor          # (k,) cascade means of the last input
    stds: torch.Tensor           # (k,) cascade stds of the last input
    war: torch.Tensor            # wet-area ratio of the last input
    mu_0: torch.Tensor           # mean rain rate over wet pixels
    velocity_unit: torch.Tensor  # (2, m, n) unit flow (BPS parallel axis)
    velocity_perp: torch.Tensor  # (2, m, n) perpendicular axis
    precip_min: torch.Tensor     # domain minimum
    precip_last: torch.Tensor    # (m, n) last observed field
    noise_filter: torch.Tensor   # (m, n//2+1) nonparametric |FFT| filter


@dataclasses.dataclass
class StepsNowcasterState:
    """Initial state of the loop; ``generator`` drives its noise draws."""

    window: torch.Tensor       # (k, p, m, n) recent normalized cascades
    precip_mask: torch.Tensor  # (m, n) rain mask (float)
    generator: torch.Generator
    eps_par: torch.Tensor      # (E,) BPS parallel perturbation draws
    eps_perp: torch.Tensor     # (E,) BPS perpendicular perturbation draws


def params_from_numpy(params, state, device, seed):
    """The port's (params, state) from the JAX package's
    ``StepsNowcasterParams`` / ``StepsNowcasterState`` given as dicts of
    numpy arrays.  JAX's ``member_keys`` has no counterpart and is dropped;
    ``seed`` seeds the port's generator instead."""
    device = torch.device(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=device)  # writable copy

    p = StepsNowcasterParams(
        **{f.name: t(params[f.name]) for f in dataclasses.fields(StepsNowcasterParams)}
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    s = StepsNowcasterState(
        window=t(state["window"]),
        precip_mask=t(state["precip_mask"]),
        generator=gen,
        eps_par=t(state["eps_par"]),
        eps_perp=t(state["eps_perp"]),
    )
    return p, s


def tree_from_numpy(tree, device):
    """Tensors on ``device`` from an init state of the JAX package given as
    numpy arrays or scalars, nested in tuples and lists (S-PROG's
    ``_sprog_init`` outputs, ANVIL's parameter maps, SSEPS's window AR
    states and parameters), with the same nesting."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_from_numpy(x, device) for x in tree)
    return torch.as_tensor(np.array(tree), device=torch.device(device))


def noise_from_numpy(noise_filt, ssft_masks, noise_std_coeffs, device):
    """The scan's noise inputs from the JAX package's init, given as numpy
    arrays: the filter as the scan takes it (2-D, after the spectral
    domain's half-plane slice, or the (wy, wx, m, n) SSFT / nested stack),
    the SSFT masks or None, and the per-level noise std coefficients.
    Returns a dict of tensors with those keys."""
    device = torch.device(device)

    def t(x):
        return None if x is None else torch.as_tensor(
            np.array(x, np.float32), device=device)

    return {"noise_filt": t(noise_filt), "ssft_masks": t(ssft_masks),
            "noise_std_coeffs": t(noise_std_coeffs)}


def _nanmin(x):
    return torch.where(torch.isnan(x), float("inf"), x).amin()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lagrangian_alignment(precip, velocity, n_iter=1, interp_order=1, max_disp=None):
    """Advect each of the p+1 input fields to the time of the last one:
    field i takes p-i unit steps along one shared displacement chain."""
    p1 = precip.shape[0]
    disps = [torch.zeros_like(velocity)]
    for _ in range(p1 - 1):
        disps.append(
            integrate_displacement(
                velocity, disps[-1], 1.0, n_iter=n_iter, max_disp=max_disp
            )
        )
    disp = torch.stack(disps[::-1])  # (p+1, 2, m, n)
    return model_warp(
        precip, disp, max_disp=max_disp, interp_order=interp_order,
        cval=float(_nanmin(precip)),
    )


def _estimate_params(precip_aligned, weights_2d, mask_thr, ar_order, conditional):
    """Decompose the aligned inputs and estimate the per-level
    autocorrelations and AR parameters."""
    mask = mask_thr if conditional else None
    levels, means, stds = decompose_core(
        precip_aligned, weights_2d, mask=mask, normalize=True
    )  # (p+1, k, m, n), (p+1, k), (p+1, k)
    cascades = levels.transpose(0, 1)  # (k, p+1, m, n)
    gamma = torch.stack(
        [
            torch.stack(correlation.temporal_autocorrelation(xs, mask=mask_thr))
            for xs in cascades
        ]
    )  # (k, ar_order)
    if ar_order == 2:
        g2 = autoregression.adjust_lag2_corrcoef2(gamma[:, 0], gamma[:, 1])
        gamma = torch.stack([gamma[:, 0], g2], dim=1)
    phi = autoregression.estimate_ar_params_yw(gamma, check_stationarity=False)
    return cascades, means, stds, gamma, phi


def _chain_available(probmatching, interp_order, max_disp, shape, on_cuda, rim=0):
    """Whether the fused match+rim+warp chain serves this configuration:
    the JAX package's gate (``pysteps_tpu/nowcasts/steps.py:247-263``),
    with the card standing in for its Pallas switch, and ``rim`` (the
    incremental mask's kr + r, 0 without it) within what stage 1 takes.
    JAX's chain has no rim limit; beyond it the scan takes the unfused
    path, which computes the same."""
    return bool(
        probmatching == "cdf"
        and interp_order == 1
        and max_disp is not None
        and pallas_chain.supported(shape)
        and rim <= pallas_chain.MAX_RIM
        and on_cuda
    )


def _ar_step_lags(lags, phi, eps=None):
    """AR(p) step on a tuple of lag tensors (oldest first), each
    (..., k, m, n); returns the shifted tuple ending in the new state."""
    p = len(lags)
    x_new = lags[p - 1] * phi[:, 0, None, None]
    for i in range(p - 1):
        x_new = x_new + lags[i] * phi[:, p - 1 - i, None, None]
    if eps is not None:
        x_new = x_new + phi[:, p, None, None] * eps
    return lags[1:] + (x_new,)


def _member_update(
    generator, cascades_j, phi, noise_filt, noise_filt_shape, weights_2d,
    noise_std_coeffs, means_last, stds_last, spectral, batch,
    use_full_fft=False, ssft_masks=None, keep=None,
):
    """A member chunk's cascade update: noise -> AR -> recompose.
    ``cascades_j``: tuple of p lags (batch, k, m, n) spatial or
    (batch, k, m, n//2+1) spectral.  ``noise_filt`` is a half-plane filter,
    a full-plane one with ``use_full_fft``, or with ``ssft_masks`` an SSFT
    / nested stack, whose noise is made in the spatial domain.  With
    ``keep`` (a slice) the noise of ``batch`` members is drawn and those
    members of it update ``cascades_j``; an empty ``keep`` only draws and
    returns (None, None).  A ``keep`` of one member of a larger ``batch``
    runs beside a neighbour of its draw (zero cascades) and returns its own
    row: the CPU's ``irfft2`` rounds a lone plane unlike the same plane in
    a batch of two or more, so a block's one-member chunk would not equal
    the unsharded run's."""
    shape = noise_filt_shape
    if keep is not None and keep.stop - keep.start == 1 < batch:
        lo = min(keep.start, batch - 2)
        i = keep.start - lo
        pair = tuple(
            torch.cat([torch.zeros_like(c), c] if i else [c, torch.zeros_like(c)])
            for c in cascades_j
        )
        cascades_j, field = _member_update(
            generator, pair, phi, noise_filt, noise_filt_shape, weights_2d,
            noise_std_coeffs, means_last, stds_last, spectral, batch,
            use_full_fft=use_full_fft, ssft_masks=ssft_masks, keep=slice(lo, lo + 2),
        )
        return tuple(c[i : i + 1] for c in cascades_j), field[i : i + 1]
    if keep is not None and keep.stop == keep.start:
        if ssft_masks is not None:
            fftgenerators._white_normal(generator, shape, batch)
        else:
            fftgenerators._fft_noise_draw(
                generator, shape, batch, "spectral" if spectral else "spatial", use_full_fft
            )
        return None, None
    if ssft_masks is not None:
        eps = fftgenerators._generate_ssft_noise(
            generator, noise_filt, ssft_masks, shape, batch, keep=keep
        )
        if spectral:
            eps_levels, _, _ = decompose_spectral_core(
                torch.fft.rfft2(eps), weights_2d, shape, normalize=True
            )
        else:
            eps_levels, _, _ = decompose_core(eps, weights_2d, normalize=True)
    elif spectral:
        eps_fft = fftgenerators._generate_fft_noise(
            generator, noise_filt, shape, batch, domain="spectral",
            standardize=False, use_full_fft=use_full_fft, keep=keep,
        )
        eps_levels, _, _ = decompose_spectral_core(
            eps_fft, weights_2d, shape, normalize=True
        )
    else:
        eps = fftgenerators._generate_fft_noise(
            generator, noise_filt, shape, batch, domain="spatial",
            standardize=False, use_full_fft=use_full_fft, keep=keep,
        )
        eps_levels, _, _ = decompose_core(eps, weights_2d, normalize=True)
    eps_levels = eps_levels * noise_std_coeffs[:, None, None]
    cascades_j = _ar_step_lags(cascades_j, phi, eps=eps_levels)
    if spectral:
        field = recompose_spectral_core(cascades_j[-1], means_last, stds_last, shape)
    else:
        field = recompose_core(cascades_j[-1], means_last, stds_last)
    return cascades_j, field


def _steps_init(
    precip, velocity, weights_2d, generator, precip_thr, taper,
    E, ar_order, conditional, mask_method, struct_radius, mask_rim,
    vel_pert, n_iter, interp_order, noise_in_graph=False, max_disp=None,
):
    """STEPS initialization: alignment, decomposition, AR estimation,
    masks, BPS draws (from ``generator``) and the noise filter."""
    m, n = precip.shape[1:]
    dev = precip.device
    if conditional:
        mask_thr = torch.all(precip >= precip_thr, dim=0)
    else:
        mask_thr = torch.ones((m, n), dtype=torch.bool, device=dev)

    with annotate("pst.init.align"):
        precip_aligned = _lagrangian_alignment(
            precip, velocity, n_iter=n_iter, interp_order=interp_order,
            max_disp=max_disp,
        )
    with annotate("pst.init.decompose"):
        cascades_full, means, stds, gamma, phi = _estimate_params(
            precip_aligned, weights_2d, mask_thr, ar_order, conditional
        )
        window = cascades_full[:, -ar_order:]  # (k, p, m, n)

    with annotate("pst.init.mask"):
        precip_last = precip[-1]
        wet = precip_last >= precip_thr
        war = (wet & mask_thr).sum().float() / torch.clamp(mask_thr.sum(), min=1)
        mu_0 = torch.where(wet, precip_last, 0.0).sum() / torch.clamp(wet.sum(), min=1)

        if mask_method == "incremental":
            mask_prec_init = nowcast_utils.compute_dilated_mask(
                wet[None], struct_radius, mask_rim
            )[0]
        elif mask_method == "obs":
            mask_prec_init = wet.to(torch.float32)
        else:
            mask_prec_init = torch.ones((m, n), dtype=torch.float32, device=dev)

    with annotate("pst.init.bps"):
        if vel_pert:
            eps_par = _laplace(generator, (E,))
            eps_perp = _laplace(generator, (E,))
            Nv = torch.linalg.vector_norm(velocity, dim=0)
            V_n = torch.where(
                Nv[None] > 1e-12, velocity / torch.clamp(Nv[None], min=1e-12), 0.0
            )
            V_perp = torch.stack([-V_n[1], V_n[0]])
        else:
            eps_par = torch.zeros(E, device=dev)
            eps_perp = torch.zeros(E, device=dev)
            V_n = torch.zeros_like(velocity)
            V_perp = torch.zeros_like(velocity)

    with annotate("pst.init.noise"):
        if noise_in_graph:
            noise_filt = fftgenerators.nonparam_filter_core(precip_aligned, taper)
        else:
            noise_filt = torch.zeros((m, n // 2 + 1), dtype=torch.float32, device=dev)

    params = StepsNowcasterParams(
        phi=phi, gamma=gamma, means=means[-1], stds=stds[-1], war=war,
        mu_0=mu_0, velocity_unit=V_n, velocity_perp=V_perp,
        precip_min=precip.min(), precip_last=precip_last, noise_filter=noise_filt,
    )
    state = StepsNowcasterState(
        window=window, precip_mask=mask_prec_init, generator=generator,
        eps_par=eps_par, eps_perp=eps_perp,
    )
    return precip_aligned, params, state


def _steps_scan(
    window, mask_prec_init, generator, velocity, phi,
    noise_filt, noise_filt_shape, weights_2d, noise_std_coeffs,
    means_last, stds_last, precip_last, precip_min, precip_thr, war, mu_0,
    domain_mask, eps_par, eps_perp, V_n, V_perp, vsf, p_par, p_perp,
    int_steps, noise, mask_method, probmatching, domain, vel_pert,
    timestep_min, mask_rim, struct_radius, n_iter, interp_order, need_det, E,
    out_dtype="float32", member_chunk=None, max_disp=None, pwl_match=False,
    use_chain=False, use_full_fft=False, ssft_masks=None, callback=None, t_chunk=None,
    members=None,
):
    """The forecast loop over ``int_steps`` lead times.  Returns the
    member-major (E, int_steps, m, n) output; with ``callback``, hands
    each lead's (E, m, n) frames to it as host numpy arrays, fetched every
    ``t_chunk`` leads from a buffer of that many, and returns None (the
    loop's state carries over from chunk to chunk).

    ``noise_filt`` is an (m, n//2+1) filter, an (m, n) full-plane one with
    ``use_full_fft`` (spatial domain), or with ``ssft_masks`` (wy, wx, m,
    n) the SSFT / nested stack and its composition masks.

    ``max_disp`` (static displacement bound or None), ``pwl_match`` (PWL
    matcher or sort matcher) and ``use_chain`` (the fused match+rim+warp
    chain, taken with the PWL matcher only) choose the path; the device of
    the tensors chooses between the kernels and their plain versions.
    ``member_chunk`` runs the members in sequential chunks of that size.
    ``members`` (start, stop) computes only those of the E members (a
    rank's block): the noise of every chunk is still drawn in full and
    the block's members kept, so they equal the unsharded run's.
    """
    del precip_min  # kept for the JAX package's signature
    m, n = precip_last.shape
    dev = precip_last.device
    spectral = domain == "spectral"
    shape = (m, n)
    if spectral:
        window = torch.fft.rfft2(window)
    ar_order = window.shape[1]
    lags0 = tuple(window[:, i] for i in range(ar_order))
    e0, e1 = members if members is not None else (0, E)
    cascades = tuple(lag.expand((e1 - e0,) + lag.shape) for lag in lags0) if noise else None
    pm_match, pm_state = (
        prepare_cdf_matcher(precip_last, pwl_match) if probmatching == "cdf"
        else (None, None)
    )
    chain_ok = use_chain and pm_match is pallas_histmatch.match_cdf_pwl
    mask_prec = mask_prec_init.expand(e1 - e0, m, n)
    det_window = lags0 if need_det else None
    # the displacement is carried on a coarse grid (full-res pixel units)
    coarse = 4 if (max_disp is not None and m % 4 == 0 and n % 4 == 0) else 1
    vel_c = coarsen_velocity(velocity, coarse)
    V_n_c = coarsen_velocity(V_n, coarse) if vel_pert else None
    V_perp_c = coarsen_velocity(V_perp, coarse) if vel_pert else None
    displacement = torch.zeros(
        (e1 - e0, 2, m // coarse, n // coarse), dtype=torch.float32, device=dev
    )
    buf_leads = min(t_chunk, int_steps) if callback is not None else int_steps
    out = torch.zeros((e1 - e0, buf_leads, m, n), dtype=getattr(torch, out_dtype), device=dev)
    t0 = 0
    mc = member_chunk if member_chunk and member_chunk < E else E
    # each chunk of the E members (its draw), its part of the computed
    # block (local indices) and that part's place in the chunk's draw
    chunks = []
    for c0 in range(0, E, mc):
        lo = max(c0, e0)
        hi = max(min(c0 + mc, e1), lo)
        chunks.append((min(mc, E - c0), slice(lo - e0, hi - e0),
                       None if members is None else slice(lo - c0, hi - c0)))
    parts_at = [s for _, s, _ in chunks if s.stop > s.start]

    def gather(parts, like):
        if len(parts) == 1:
            return parts[0]
        full = torch.empty_like(like)
        for s, part in zip(parts_at, parts):
            full[s] = part
        return full

    for t in range(int_steps):
        t_total = np.float32((t + 1.0) * timestep_min)
        if det_window is not None:
            det_window = _ar_step_lags(det_window, phi)
            if spectral:
                det_field = recompose_spectral_core(
                    det_window[-1], means_last, stds_last, shape
                )
            else:
                det_field = recompose_core(det_window[-1], means_last, stds_last)
            sprog_m = nowcast_utils.compute_percentile_mask(det_field, war)

        new_lags, new_masks, new_disps = [], [], []
        for n_draw, s, keep in chunks:
            with annotate("pst.lead"):
                Ec = s.stop - s.start
                if noise:
                    with annotate("pst.update"):
                        casc_j, field = _member_update(
                            generator, tuple(c[s] for c in cascades), phi, noise_filt,
                            noise_filt_shape, weights_2d, noise_std_coeffs,
                            means_last, stds_last, spectral, n_draw,
                            use_full_fft=use_full_fft, ssft_masks=ssft_masks, keep=keep,
                        )
                    if Ec == 0:  # a chunk outside the block: its draw only
                        continue
                    new_lags.append(casc_j[-1])
                elif Ec == 0:
                    continue
                else:
                    field = det_field.expand(Ec, m, n)
                mask_j = mask_prec[s]

                with annotate("pst.mask"):
                    fmin = field.amin(dim=(-2, -1), keepdim=True)
                    if mask_method == "incremental":
                        field = fmin + (field - fmin) * mask_j
                        field = torch.where(field > fmin, field, fmin)
                    elif mask_method == "obs":
                        field = torch.where(mask_j > 0, field, fmin)
                    elif mask_method == "sprog":
                        field = torch.where(sprog_m, field, fmin)

                with annotate("pst.warp"):
                    if vel_pert:
                        a1, b1, c1 = (np.float32(v) for v in p_par)
                        a2, b2, c2 = (np.float32(v) for v in p_perp)
                        g_par = float(a1 * t_total**b1 + c1)
                        g_perp = float(a2 * t_total**b2 + c2)
                        gs = slice(e0 + s.start, e0 + s.stop)
                        vel_j = vel_c + (
                            eps_par[gs, None, None, None] * g_par * V_n_c
                            + eps_perp[gs, None, None, None] * g_perp * V_perp_c
                        ) / vsf
                    else:
                        vel_j = vel_c
                    disp_j = integrate_displacement_coarse(
                        vel_j, displacement[s], 1.0, n_iter=n_iter, max_disp=max_disp,
                        coarse=coarse,
                    )
                    new_disps.append(disp_j)

                if chain_ok:
                    with annotate("pst.match"):
                        edges, d0, d1, q0, zval, ztrg = pallas_histmatch.build_pwl_coeffs(
                            field.reshape(Ec, -1), pm_state
                        )
                        e8, T = pallas_histmatch.pack_gather_lut(edges, d0, d1)
                    # fused match + rim + warp (two kernel launches)
                    with annotate("pst.chain"):
                        dy_f, disp_t = upsample_planes(disp_j, shape, coarse)
                        out_field, rim_new = pallas_chain.match_warp_rim(
                            field.contiguous(), e8, T, q0, zval, ztrg, precip_thr, dy_f,
                            disp_t, float("nan"), max_disp,
                            struct_radius if struct_radius else 1,
                            mask_rim if mask_rim else 0,
                            do_rim=mask_method == "incremental",
                        )
                    if mask_method == "incremental":
                        new_masks.append(rim_new)
                else:
                    with annotate("pst.match"):
                        if probmatching == "cdf":
                            field = pm_match(field, pm_state)
                        elif probmatching == "mean":
                            wet = field >= precip_thr
                            mu_fct = torch.where(wet, field, 0.0).sum(
                                dim=(-2, -1), keepdim=True
                            )
                            mu_fct = mu_fct / torch.clamp(
                                wet.sum(dim=(-2, -1), keepdim=True), min=1
                            )
                            field = torch.where(wet, field - mu_fct + mu_0, field)

                    if mask_method == "incremental":
                        with annotate("pst.mask"):
                            new_masks.append(
                                nowcast_utils.compute_dilated_mask_from_field(
                                    field, precip_thr, struct_radius, mask_rim
                                )
                            )

                    with annotate("pst.warp"):
                        out_field = model_warp_coarse(
                            field, disp_j, shape, coarse, max_disp=max_disp,
                            interp_order=interp_order, cval=float("nan"),
                        )
                with annotate("pst.write"):
                    out[s, t - t0] = torch.where(
                        domain_mask, float("nan"), out_field
                    ).to(out.dtype)

        if noise:
            cascades = cascades[1:] + (gather(new_lags, cascades[-1]),)
        if mask_method == "incremental":
            mask_prec = gather(new_masks, mask_prec)
        displacement = gather(new_disps, displacement)
        if callback is not None and (t + 1 - t0 == buf_leads or t + 1 == int_steps):
            with annotate("pst.stream"):
                nowcast_utils.stream_leads(out, t + 1 - t0, callback)
            t0 = t + 1
    return None if callback is not None else out


def _noise_init(cfg, precip, precip_aligned, params, bp_filter, generator, shape):
    """The scan's noise inputs: (filter, use_full_fft, SSFT masks or None,
    per-level noise std coefficients (k,)).  The nonparametric filter comes
    from the init; the other methods build theirs from the aligned inputs
    on the forecast's device (JAX: ``pysteps_tpu/nowcasts/steps.py:664-719``).
    ``"auto"`` draws its 20 noise realizations from ``generator``."""
    m, n = shape
    device = precip.device
    k_levels = cfg.n_cascade_levels
    noise_filt = params.noise_filter
    use_full_fft = False
    ssft_masks = None
    noise_std_coeffs = torch.ones(k_levels, dtype=torch.float32, device=device)
    if cfg.noise_method is None:
        return noise_filt, use_full_fft, ssft_masks, noise_std_coeffs
    if cfg.noise_method == "nonparametric":
        pert_gen = {"field": noise_filt, "input_shape": (m, n), "use_full_fft": False}
    else:
        init_noise, _ = noise.get_method(cfg.noise_method)
        pert_gen = init_noise(precip_aligned, **cfg.noise_kwargs)
        noise_filt = pert_gen["field"].to(torch.float32)
        use_full_fft = bool(pert_gen.get("use_full_fft", False))
        if cfg.domain == "spectral" and use_full_fft and noise_filt.ndim == 2:
            # the spectral AR state lives in rfft2 half-planes; a full-plane
            # filter magnitude is Hermitian-symmetric, so its left half is
            # the half-plane filter
            noise_filt = noise_filt[:, : n // 2 + 1]
            use_full_fft = False
        if noise_filt.ndim == 4:  # SSFT / nested (wy, wx, m, n) stack
            ssft_masks = fftgenerators._ssft_gen_masks(
                noise_filt.shape, (m, n), pert_gen.get("overlap_gen", 0.2),
                pert_gen.get("win_fun", "tukey"), device,
            )
    if cfg.noise_stddev_adj == "auto":
        noise_std_coeffs = noise.utils.compute_noise_stddev_adjs(
            precip[-1], cfg.precip_threshold, float(params.precip_min),
            bp_filter, None, pert_gen, None, 20,
            conditional=True, generator=generator,
        ).to(torch.float32)
    elif cfg.noise_stddev_adj == "fixed":
        noise_std_coeffs = torch.tensor(
            [1.0 / (0.75 + 0.09 * k) for k in range(1, k_levels + 1)],
            dtype=torch.float32, device=device,
        )
    return noise_filt, use_full_fft, ssft_masks, noise_std_coeffs


def _steps_forecast(precip, velocity, timesteps, cfg, domain_mask, device):
    """Initialization + loop.  Returns (out (E, T, m, n), init_s, loop_s),
    with out None when the loop streamed its frames to the callback."""
    t_init0 = time.perf_counter()
    with annotate("pst.init"):
        m, n = precip.shape[1:]
        p = cfg.ar_order
        E = cfg.n_ens_members
        k_levels = cfg.n_cascade_levels

        if isinstance(timesteps, int):
            int_steps = timesteps
            subsel = None
        else:
            subsel = list(timesteps)
            int_steps = int(np.ceil(max(subsel)))

        with annotate("pst.init.filter"):
            filter_method = cascade.get_method(cfg.bandpass_filter_method)
            bp_filter = filter_method((m, n), k_levels, **cfg.filter_kwargs)
            weights_2d = torch.tensor(
                bp_filter["weights_2d"], dtype=torch.float32, device=device
            )
            noise_in_graph = cfg.noise_method == "nonparametric"
            win_fun = cfg.noise_kwargs.get("win_fun", "tukey") if noise_in_graph else None
            taper = torch.as_tensor(
                tapering_utils.compute_window_function(m, n, win_fun)
                if win_fun is not None else np.ones((m, n)),
                dtype=torch.float32, device=device,
            )

        generator = torch.Generator(device=device)
        generator.manual_seed(cfg.seed if cfg.seed is not None else 42)

        extrap_kwargs = dict(cfg.extrapolation_kwargs)
        n_iter = extrap_kwargs.get("n_iter", 1)
        interp_order = extrap_kwargs.get("interp_order", 1)

        vel_pert = cfg.velocity_perturbation_method is not None
        if vel_pert:
            vp_kwargs = dict(cfg.velocity_perturbation_kwargs)
            p_par = tuple(float(v) for v in vp_kwargs.get("p_par", get_default_params_bps_par()))
            p_perp = tuple(float(v) for v in vp_kwargs.get("p_perp", get_default_params_bps_perp()))
            vsf = 60.0 / (cfg.timestep * (1.0 / cfg.kmperpixel))
        else:
            p_par = p_perp = None
            vsf = 1.0

        mask_rim = None
        struct_radius = 1
        if cfg.mask_method == "incremental":
            mask_rim = int(cfg.mask_kwargs.get("mask_rim", 10))
            mask_f = cfg.mask_kwargs.get("mask_f", 1.0)
            # structuring element scaled by the per-step motion extent
            if cfg.timestep is not None and cfg.kmperpixel is not None:
                n_struct = mask_f * cfg.timestep / cfg.kmperpixel
            else:
                n_struct = 3.0
            struct_radius = max(int((n_struct - 1) / 2.0), 1)

        precip_thr_f = float(
            np.float32(cfg.precip_threshold if cfg.precip_threshold is not None else 0.0)
        )

        # static displacement bounds select the shift-decomposition kernels
        # (K1/K2); on the CPU the exact gather is the path, as in the JAX package
        on_cpu = device.type == "cpu"
        if not on_cpu and min(m, n) >= 3 * _MAX_DISP:
            max_disp_align = max_disp_scan = _MAX_DISP
        else:
            vmax = float(velocity.abs().max()) if velocity.numel() else 0.0
            if vel_pert:
                # 4-sigma Laplace margin on the BPS perturbation at the last lead
                t_last = int_steps * (cfg.timestep or 1.0)
                g_par = abs(p_par[0] * t_last ** p_par[1] + p_par[2])
                g_perp = abs(p_perp[0] * t_last ** p_perp[1] + p_perp[2])
                pert_margin = 4.0 * max(g_par, g_perp) / max(vsf, 1e-6)
            else:
                pert_margin = 0.0
            max_disp_align = max(int(np.ceil(p * (vmax + 1.0))) + 1, 2)
            max_disp_scan = max(
                int(np.ceil(int_steps * (vmax + pert_margin))) + 2, max_disp_align
            )
            max_disp_scan = min(max_disp_scan, _MAX_DISP)
            if max_disp_scan > min(m, n) // 3:
                max_disp_scan = None
            if on_cpu:
                max_disp_align = max_disp_scan = None

        precip_aligned, params, state = _steps_init(
            precip, velocity, weights_2d, generator, precip_thr_f, taper,
            E=E, ar_order=p, conditional=cfg.conditional,
            mask_method=cfg.mask_method, struct_radius=struct_radius,
            mask_rim=mask_rim if mask_rim is not None else 0,
            vel_pert=vel_pert, n_iter=n_iter, interp_order=interp_order,
            noise_in_graph=noise_in_graph, max_disp=max_disp_align,
        )
        with annotate("pst.init.noise"):
            noise_filt, use_full_fft, ssft_masks, noise_std_coeffs = _noise_init(
                cfg, precip, precip_aligned, params, bp_filter, generator, (m, n)
            )
        del precip_aligned

        member_chunk = (
            cfg.member_chunk if cfg.member_chunk and E % cfg.member_chunk == 0 else None
        )
        # the members split over the mesh's "ens" dimension where it has more
        # than one rank and divides E (the JAX package's rule)
        ens = axis_size(cfg.mesh, "ens") if cfg.mesh is not None else 1
        members = member_block(E, cfg.mesh) if ens > 1 and E % ens == 0 else None
        if cfg.measure_time:
            _sync(device)
    init_time = time.perf_counter() - t_init0
    t_loop0 = time.perf_counter()
    with annotate("pst.loop"):
        # the streaming contract: chunks of at most 6 leads reach the callback
        # and leave the device, so it never holds E x T frames
        stream = (cfg.callback is not None and not cfg.return_output and subsel is None
                  and members is None)
        out = _steps_scan(
            state.window, state.precip_mask, state.generator, velocity, params.phi,
            noise_filt, (m, n), weights_2d, noise_std_coeffs,
            params.means, params.stds, params.precip_last, params.precip_min,
            precip_thr_f, params.war, params.mu_0, domain_mask,
            state.eps_par, state.eps_perp, params.velocity_unit, params.velocity_perp,
            vsf, p_par, p_perp, int_steps,
            noise=cfg.noise_method is not None,
            mask_method=cfg.mask_method,
            probmatching=cfg.probmatching_method,
            domain=cfg.domain,
            vel_pert=vel_pert,
            timestep_min=float(cfg.timestep) if cfg.timestep else 1.0,
            mask_rim=mask_rim,
            struct_radius=struct_radius,
            n_iter=n_iter,
            interp_order=interp_order,
            need_det=cfg.noise_method is None or cfg.mask_method == "sprog",
            E=E,
            out_dtype=cfg.output_dtype,
            member_chunk=member_chunk,
            max_disp=max_disp_scan,
            pwl_match=not on_cpu and pallas_histmatch.supported((m, n)),
            use_chain=_chain_available(
                cfg.probmatching_method, interp_order, max_disp_scan, (m, n),
                not on_cpu,
                rim=(struct_radius or 1) + (mask_rim or 0)
                if cfg.mask_method == "incremental" else 0,
            ),
            use_full_fft=use_full_fft,
            ssft_masks=ssft_masks,
            callback=cfg.callback if stream else None,
            t_chunk=6,
            members=members,
        )
        if members is not None:
            out = all_gather_cat(out, cfg.mesh, "ens", dim=0)
        if cfg.measure_time:
            _sync(device)
    loop_time = time.perf_counter() - t_loop0

    if subsel is not None:
        with annotate("pst.write"):
            out = nowcast_utils.interpolate_leads(out, subsel, axis=1)
    return out, init_time, loop_time


class StepsNowcaster:
    """Host orchestration around the STEPS init and loop."""

    def __init__(self, precip, velocity, timesteps, steps_config, device):
        self.device = device
        self.precip = (
            precip.detach().cpu().numpy() if isinstance(precip, torch.Tensor)
            else np.asarray(precip)
        )
        self.velocity = (
            velocity.detach().cpu().numpy() if isinstance(velocity, torch.Tensor)
            else np.asarray(velocity)
        )
        self.timesteps = timesteps
        self.config = steps_config

    def compute_forecast(self):
        cfg = self.config
        t0 = time.perf_counter()
        with annotate("pst.gate"):
            self._check_inputs()
            if check_norain(
                self.precip, cfg.precip_threshold, cfg.norain_threshold,
                cfg.noise_kwargs.get("win_fun", "tukey"), printmsg=True,
            ):
                return nowcast_utils.zero_precipitation_forecast(
                    cfg.n_ens_members, self.timesteps, self.precip, self.device,
                    cfg.callback, cfg.return_output, cfg.measure_time, t0,
                )
            precip_np = self.precip[-(cfg.ar_order + 1):].astype(np.float32)
            domain_mask = ~np.isfinite(precip_np[-1])
            precip_np = np.where(np.isfinite(precip_np), precip_np, np.nanmin(precip_np))
            precip_t = torch.as_tensor(precip_np, device=self.device)
            velocity_t = torch.as_tensor(self.velocity, dtype=torch.float32, device=self.device)
            domain_mask_t = torch.as_tensor(domain_mask, device=self.device)
        out, init_time, loop_time = _steps_forecast(
            precip_t, velocity_t, self.timesteps, cfg, domain_mask_t, self.device
        )
        if cfg.callback is not None and out is not None:
            with annotate("pst.stream"):
                nowcast_utils.stream_leads(out, out.shape[1], cfg.callback)
        result = out if cfg.return_output else None
        if cfg.measure_time:
            return result, init_time, loop_time
        return result

    def _check_inputs(self):
        cfg = self.config
        if self.precip.ndim != 3:
            raise ValueError("precip must be a three-dimensional array")
        if self.precip.shape[0] < cfg.ar_order + 1:
            raise ValueError(
                f"precip.shape[0] must be at least ar_order+1 "
                f"({cfg.ar_order + 1}), got {self.precip.shape[0]}"
            )
        if self.velocity.ndim != 3:
            raise ValueError("velocity must be a three-dimensional array")
        if self.precip.shape[1:] != self.velocity.shape[1:]:
            raise ValueError("dimension mismatch between precip and velocity")
        if isinstance(self.timesteps, list) and sorted(self.timesteps) != list(self.timesteps):
            raise ValueError("timesteps is not in ascending order")
        if cfg.conditional and cfg.precip_threshold is None:
            raise ValueError("conditional=True but precip_threshold is not set")
        if cfg.mask_method is not None and cfg.precip_threshold is None:
            raise ValueError(
                f"mask_method={cfg.mask_method} but precip_threshold is not set"
            )
        if cfg.noise_stddev_adj == "auto" and cfg.precip_threshold is None:
            raise ValueError("noise_stddev_adj='auto' but precip_threshold not set")
        if cfg.noise_stddev_adj not in ("auto", "fixed", None):
            raise ValueError(f"unknown noise_stddev_adj {cfg.noise_stddev_adj}")
        if cfg.noise_method not in _NOISE_METHODS:
            raise ValueError(f"unknown noise_method {cfg.noise_method}")
        if cfg.mesh is not None and not isinstance(cfg.mesh, DeviceMesh):
            raise TypeError("mesh must be a DeviceMesh (parallel.make_mesh)")
        if cfg.mesh is not None and cfg.mesh.device_type != self.device.type:
            raise ValueError(
                f"a {cfg.mesh.device_type} mesh cannot run a forecast on {self.device}"
            )
        if cfg.domain not in ("spatial", "spectral"):
            raise ValueError(f"unknown domain {cfg.domain}")
        if cfg.velocity_perturbation_method not in (None, "bps"):
            raise ValueError(
                f"unknown vel_pert_method {cfg.velocity_perturbation_method}"
            )
        if cfg.velocity_perturbation_method is not None:
            if cfg.kmperpixel is None:
                raise ValueError("vel_pert_method is set but kmperpixel=None")
            if cfg.timestep is None:
                raise ValueError("vel_pert_method is set but timestep=None")


def forecast(
    precip,
    velocity,
    timesteps,
    n_ens_members=24,
    n_cascade_levels=6,
    precip_thr=None,
    norain_thr=0.0,
    kmperpixel=None,
    timestep=None,
    extrap_method="semilagrangian",
    decomp_method="fft",
    bandpass_filter_method="gaussian",
    noise_method="nonparametric",
    noise_stddev_adj=None,
    ar_order=2,
    vel_pert_method="bps",
    conditional=False,
    probmatching_method="cdf",
    mask_method="incremental",
    seed=None,
    num_workers=1,
    fft_method="numpy",
    domain="spatial",
    extrap_kwargs=None,
    filter_kwargs=None,
    noise_kwargs=None,
    vel_pert_kwargs=None,
    mask_kwargs=None,
    measure_time=False,
    callback=None,
    return_output=True,
    member_chunk=None,
    mesh=None,
    output_dtype="float32",
    device=None,
):
    """STEPS nowcast with the JAX package's signature plus ``device``.
    Returns an (n_ens_members, T, m, n) tensor on ``device``: CUDA unless
    the caller asks for the CPU (or passes CPU tensors); raises
    ``RuntimeError`` when CUDA is needed and absent.  ``callback`` gets
    each lead's (E, m, n) frames as host numpy arrays; with
    ``return_output=False`` (and an int ``timesteps``) the loop streams
    them in chunks of at most 6 leads and returns None.  With ``mesh`` (a
    ``parallel.make_mesh`` mesh, every rank calling with the same inputs)
    the members split over its "ens" dimension where that has more than
    one rank and divides ``n_ens_members``, and every rank gets the whole
    ensemble, equal to the unsharded forecast's."""
    with annotate("pst.gate"):
        device = resolve_device(device, precip, velocity)
        config = StepsNowcasterConfig(
            n_ens_members=n_ens_members,
            n_cascade_levels=n_cascade_levels,
            precip_threshold=precip_thr,
            norain_threshold=norain_thr,
            kmperpixel=kmperpixel,
            timestep=timestep,
            extrapolation_method=extrap_method,
            decomposition_method=decomp_method,
            bandpass_filter_method=bandpass_filter_method,
            noise_method=noise_method,
            noise_stddev_adj=noise_stddev_adj,
            ar_order=ar_order,
            velocity_perturbation_method=vel_pert_method,
            conditional=conditional,
            probmatching_method=probmatching_method,
            mask_method=mask_method,
            seed=seed,
            num_workers=num_workers,
            fft_method=fft_method,
            domain=domain,
            extrapolation_kwargs=extrap_kwargs or {},
            filter_kwargs=filter_kwargs or {},
            noise_kwargs=noise_kwargs or {},
            velocity_perturbation_kwargs=vel_pert_kwargs or {},
            mask_kwargs=mask_kwargs or {},
            measure_time=measure_time,
            callback=callback,
            return_output=return_output,
            member_chunk=member_chunk,
            mesh=mesh,
            output_dtype=output_dtype,
        )
        nowcaster = StepsNowcaster(precip, velocity, timesteps, config, device)
    return nowcaster.compute_forecast()
