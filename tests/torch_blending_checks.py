"""Card-against-CPU checks of the port's blending, shared by
``tests/test_torch_blending_cuda.py`` and ``chip_smoke.py``.  It imports
numpy, torch and the port only (the chip check imports it, and nothing of
JAX may load there); every check needs a CUDA card.

- :func:`nanclose`: identical NaN sets and a bound on the difference,
  everywhere or at a share of the pixels;
- :func:`steps_card_vs_cpu`: STEPS blending's card branch (the shift path,
  K1 and K4 from a mask) against the CPU forced onto the same branch;
- :func:`chunk_check`: member chunks and the bfloat16 output on the card;
- :func:`enkf_card_vs_cpu`: one PCA EnKF cycle on both devices from one
  state."""

import time

import numpy as np
import torch

from pysteps_tpu_torch import blending, cascade
from pysteps_tpu_torch.blending import ens_kalman_filter_methods as enkf
from pysteps_tpu_torch.blending import pca_ens_kalman_filter as pca_enkf
from pysteps_tpu_torch.blending import steps as bsteps
from pysteps_tpu_torch.ops import _kernels

# matched outputs, card against CPU: the exact CDF match swaps the ranks of
# pixels within rounding of each other, which then take each other's
# target quantile (see tests/test_torch_blending_steps.py)
BLEND_TOL = dict(rel=1e-3, frac=0.999, mean_rel=1e-4)
# the EnKF analysis on both devices, of its largest value, and the filter's
# scalars
ANALYSIS_TOL, SCALARS_TOL = 1e-3, 1e-4
# the filter's options in the checked cycle: JAX's defaults
ENKF_FILTER = dict(precip_thr=-10.0, norain_thr=0.01, n_ens_prec=1, non_precip_mask=True,
                   lien_criterion=True, inflation_factor_bg=1.0, inflation_factor_obs=1.0,
                   offset_bg=0.0, offset_obs=0.0, iterative_prob_matching=True,
                   sampling_prob_source="ensemble", use_accum=False,
                   ensure_full_nwp_weight=True)


def nanclose(label, card, cpu, rel, of_span=True, frac=None, mean_rel=None, max_rel=None):
    """Raise unless the card's output and the CPU's have identical NaN sets
    and differ by at most ``rel`` x span (x 1 without ``of_span``) at
    every pixel, or, with ``frac``, at that share of the pixels, by at
    most ``mean_rel`` x span on average and, with ``max_rel``, by at most
    that x span anywhere; returns the comparison."""
    c = torch.as_tensor(card).detach().cpu().double().numpy()
    r = torch.as_tensor(cpu).detach().cpu().double().numpy()
    if c.shape != r.shape:
        raise AssertionError(f"{label}: card shape {c.shape} != CPU shape {r.shape}")
    nan_c, nan_r = np.isnan(c), np.isnan(r)
    if not np.array_equal(nan_c, nan_r):
        raise AssertionError(f"{label}: NaN sets differ ({int((nan_c != nan_r).sum())} pixels)")
    scale = float(np.nanmax(r) - np.nanmin(r)) if of_span else 1.0
    diff = np.abs(np.nan_to_num(c) - np.nan_to_num(r))
    rec = {"tol": rel, "of": "span" if of_span else "value", "scale": scale,
           "max_abs_diff": float(diff.max()), "max_abs_diff_over_scale": float(diff.max() / scale),
           "mean_abs_diff_over_scale": float(diff.mean() / scale),
           "nan_fraction": float(nan_r.mean())}
    if frac is None:
        ok = diff.max() <= rel * scale
    else:
        rec["frac_within_tol"] = float((diff <= rel * scale).mean())
        rec.update(frac_required=frac, mean_tol=mean_rel, max_tol=max_rel)
        ok = rec["frac_within_tol"] >= frac and diff.mean() <= mean_rel * scale and (
            max_rel is None or diff.max() <= max_rel * scale)
    if not ok:
        raise AssertionError(f"{label}: card and CPU disagree: {rec}")
    return rec


def matched_close(label, card, cpu):
    """:func:`nanclose` at ``BLEND_TOL``, for outputs that end in the CDF
    match."""
    return nanclose(label, card, cpu, BLEND_TOL["rel"], frac=BLEND_TOL["frac"],
                    mean_rel=BLEND_TOL["mean_rel"])


def _launches_are(label, expected):
    launches = dict(_kernels.LAUNCHES)
    if launches != dict(dict.fromkeys(launches, 0), **expected):
        raise AssertionError(f"{label}: launches {launches}, expected {expected}")


def steps_card_vs_cpu(label, db, nwp, velocity, T, kw):
    """STEPS blending on the card (the shift path: exactly 3 K1 launches an
    axis and 1 rim from a mask a lead, and 1 at init) against the CPU
    given the card's displacement bound (``extrap_kwargs["max_disp"]``),
    which then runs the plain versions of K1 and K4.  ``db`` (3, m, n),
    ``nwp`` (1, >= T + 1, m, n) and ``velocity`` (2, m, n) numpy; ``kw`` a
    deterministic configuration.  Returns the comparison."""
    f = blending.get_method("steps")
    max_disp = bsteps._scan_bound(float(np.abs(velocity).max()), T, 5.0, False, None, None,
                                  1.0, tuple(db.shape[-2:]))
    if max_disp is None:
        raise AssertionError(f"{label}: no displacement bound, so no shift path")
    _kernels.reset_launches()
    t0 = time.time()
    card = f(db, nwp, velocity, velocity[None], T, 5.0, **kw)
    torch.cuda.synchronize()
    t1 = time.time()
    if not card.is_cuda:
        raise AssertionError(f"{label}: the card's output is on {card.device}")
    _launches_are(label, {"resample_axis0": 3 * T, "resample_axis1": 3 * T,
                          "rim_from_mask": 1 + T})
    cpu = f(db, nwp, velocity, velocity[None], T, 5.0, device="cpu",
            extrap_kwargs={"max_disp": max_disp}, **kw)
    return dict(matched_close(label, card, cpu), shape=list(card.shape), max_disp=max_disp,
                card_s=t1 - t0, cpu_s=time.time() - t1)


def chunk_check(label, db, nwp, velocity, T, kw):
    """On the card, member chunks of 2 against one chunk (held as
    :func:`matched_close`) and the bfloat16 output equal to the float32
    output rounded, for the inputs of :func:`steps_card_vs_cpu`."""
    f = blending.get_method("steps")
    full = f(db, nwp, velocity, velocity[None], T, 5.0, **kw)
    chunked = f(db, nwp, velocity, velocity[None], T, 5.0, member_chunk=2, **kw)
    half = f(db, nwp, velocity, velocity[None], T, 5.0, member_chunk=2,
             output_dtype="bfloat16", **kw)
    held = matched_close(label, chunked, full)
    if half.dtype != torch.bfloat16 or not torch.equal(half, chunked.to(torch.bfloat16)):
        raise AssertionError(f"{label}: the bfloat16 output is not the float32 output rounded")
    return dict(held, shape=list(full.shape), member_chunk=2, bfloat16_equal=True)


def enkf_cycle(dev, state, pool, idx, pick, velocity, w2, max_disp=48):
    """One correction (``ENKF_FILTER``) and one nowcast step of the PCA EnKF
    on ``dev`` from the same state, noise pool, picks and Bernoulli draws;
    returns (analysis, forecast, the filter's scalars) on the CPU."""
    nwc, nwp_t, casc, mu, sig = (x.to(dev) for x in state)
    E = nwc.shape[0]
    scal = [torch.tensor(v, device=dev) for v in (0.0, 0.0, 1.0, 0.2)]
    corr = enkf.masked_enkf_correct_core(nwc, nwp_t, nwc, None, *scal,
                                         taper=torch.eye(2 * E, device=dev),
                                         pick=pick.to(dev), n_lien=E // 2, **ENKF_FILTER)
    k = w2.shape[0]
    out = pca_enkf._forecast_core(
        corr[0], casc, mu, sig, None, nwp_t, corr[1], w2.to(dev),
        torch.tensor([[0.95, 0.3]] * k, device=dev), torch.ones(k, device=dev),
        torch.ones(k, dtype=torch.bool, device=dev), pool.to(dev),
        torch.as_tensor(velocity, device=dev), torch.zeros_like(nwc[0], dtype=torch.bool),
        -10.0, -12.0, True, 1, max_disp, idx=idx.to(dev))
    return corr[0].cpu(), out[0].cpu(), [float(x) for x in corr[2:]]


def enkf_card_vs_cpu(label, members, velocity, k, n_pool, max_disp=48):
    """One PCA EnKF cycle (:func:`enkf_cycle`, the nowcast step on the shift
    path: 3 K1 launches an axis) on the card and on the CPU from one
    state: the ensemble ``members`` (E, >= 3, m, n) CPU tensor at its
    second field as the background, its third as the observation, ``k``
    levels, a pool of ``n_pool`` noise cascades drawn once, fixed picks
    and Bernoulli draws.  The analysis within ``ANALYSIS_TOL`` of its
    largest value, the scalars within ``SCALARS_TOL``, the forecast as
    :func:`matched_close`.  Returns the comparison."""
    E, _, m, n = members.shape
    w2 = torch.tensor(cascade.get_method("gaussian")((m, n), k)["weights_2d"],
                      dtype=torch.float32)
    nwc = members[:, 1].clone()
    levels, mu, sig = pca_enkf.decompose_core(nwc, w2)
    gen = torch.Generator().manual_seed(3)
    pool = pca_enkf._init_noise_pool(gen, torch.ones(m, n // 2 + 1), (m, n), False, w2,
                                     n_pool, k)
    idx = torch.randint(0, n_pool, (E,), generator=gen)
    pick = torch.rand((E, m * n), generator=gen) < 0.5
    state = (nwc, members[:, 2], levels[:, :, None], mu, sig)
    _kernels.reset_launches()
    t0 = time.time()
    card = enkf_cycle(torch.device("cuda"), state, pool, idx, pick, velocity, w2, max_disp)
    t1 = time.time()
    _launches_are(label, {"resample_axis0": 3, "resample_axis1": 3})
    ref = enkf_cycle(torch.device("cpu"), state, pool, idx, pick, velocity, w2, max_disp)
    t2 = time.time()
    analysis_err = float((card[0] - ref[0]).abs().max()) / float(ref[0].abs().max())
    scalars_err = max(abs(a - b) for a, b in zip(card[2], ref[2]))
    if analysis_err > ANALYSIS_TOL or scalars_err > SCALARS_TOL:
        raise AssertionError(f"{label}: the card's correction differs from the CPU's by "
                             f"{analysis_err} of its largest value, scalars {card[2]} {ref[2]}")
    held = matched_close(label, card[1][:, None], ref[1][:, None])
    return dict(held, analysis_max_abs_diff_over_max=analysis_err, analysis_tol=ANALYSIS_TOL,
                filter_scalars_card=card[2], filter_scalars_cpu=ref[2],
                scalars_tol=SCALARS_TOL, card_s=t1 - t0, cpu_s=t2 - t1)
