"""
Ensemble Kalman filter update of the PCA EnKF combination (counterpart of
``pysteps_tpu/blending/ens_kalman_filter_methods.py``; Nerini et al.
2019).

The covariance build, taper, Kalman gain solve and analysis update are
matmuls over (n_ens, n_pc) matrices on the ensemble's device.
:func:`masked_enkf_correct_core` is the correction the combination loop
runs, on all members at once; the classes keep the JAX package's
interface.  Eigenvectors, and so principal components, are fixed up to
their sign, which the libraries choose differently: the scores' signs
cancel in every product the update forms.
"""

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.nowcasts.utils import to_numpy
from pysteps_tpu_torch.postprocessing import probmatching
from pysteps_tpu_torch.utils.arrays import _nanmin


def _resample_core(a, b, p_first, generator=None, pick=None):
    """Binomial mix of the descending-sorted samples of each row of ``a``
    and ``b`` (E, N): each rank takes ``a``'s value with probability
    ``p_first``.  NaNs take the row's smallest value of both first.  The
    draw ``pick`` (E, N) comes from ``generator`` unless given."""
    fill = torch.minimum(_nanmin(a, dim=1), _nanmin(b, dim=1))[:, None]
    a = torch.where(torch.isnan(a), fill, a)
    b = torch.where(torch.isnan(b), fill, b)
    asort = torch.sort(a, dim=1, descending=True).values
    bsort = torch.sort(b, dim=1, descending=True).values
    if pick is None:
        pick = probmatching._bernoulli(generator, p_first, asort.shape)
    return torch.where(pick, asort, bsort)


def masked_enkf_correct_core(
    bg, obs, resampled, generator, samp_prob, accum_prob, infl_prev, degrade_t,
    *, precip_thr, norain_thr, n_ens_prec, n_lien, non_precip_mask, lien_criterion,
    taper, inflation_factor_bg, inflation_factor_obs, offset_bg, offset_obs,
    iterative_prob_matching, sampling_prob_source, use_accum, ensure_full_nwp_weight,
    pick=None,
):
    """The masked EnKF correction of the (E, m, n) background ``bg`` by the
    NWP ensemble ``obs`` (semantics of ``MaskedEnKF.correct_step``,
    reference: ens_kalman_filter_methods.py:452-628), with the JAX
    package's two equivalent changes: the non-rainy columns are zeroed
    before the PCA fit instead of gathered out, and the fit is the Gram
    trick (a 2E x 2E ``eigh``) instead of the economy SVD.

    ``samp_prob``, ``accum_prob``, ``infl_prev`` and ``degrade_t`` are the
    filter's carried scalars (0-d tensors).  ``pick`` (E, m*n), the
    Bernoulli draw of the resampled target, comes from ``generator``
    unless given.  Returns ``(analysis, resampled, samp_prob, accum_prob,
    infl_obs_tmp, degrade_t)``."""
    E = bg.shape[0]
    bgf = bg.reshape(E, -1)
    obsf = obs.reshape(E, -1)
    n2 = 2 * E

    # full-NWP-weight assurance near total NWP trust: runs before the
    # update, on last cycle's accumulated probability
    close1 = torch.abs(accum_prob - 1.0) <= (1e-8 + 1e-2 * 1.0)
    infl_tmp = torch.where(
        close1, torch.cos(degrade_t),
        inflation_factor_obs - accum_prob * (inflation_factor_obs - 1.0))
    degrade_new = torch.where(close1, degrade_t + 0.2, degrade_t)

    # rainy-pixel selection and the Lien criterion
    cnt_bg = (bgf >= precip_thr).sum(dim=0)
    cnt_obs = (obsf >= precip_thr).sum(dim=0)
    if non_precip_mask:
        idx_prec = (cnt_bg >= n_ens_prec) | (cnt_obs >= n_ens_prec)
    else:
        idx_prec = torch.ones_like(cnt_bg, dtype=torch.bool)
    if lien_criterion:
        lien = (cnt_bg >= n_lien) & (cnt_obs >= n_lien)
    else:
        lien = torch.ones_like(cnt_bg, dtype=torch.bool)
    mask_p = idx_prec.to(torch.float32)
    mask_lb = idx_prec & lien
    mask_l = mask_lb.to(torch.float32)

    X = torch.cat([bgf, obsf], dim=0)
    X = torch.where(torch.isfinite(X), X, norain_thr)

    # PCA of the masked stacked ensembles by the Gram trick
    mean = X.mean(dim=0)
    Xc = (X - mean) * mask_p
    lam, U = torch.linalg.eigh(Xc @ Xc.T)
    lam = torch.flip(lam, dims=(0,))
    U = torch.flip(U, dims=(1,))
    S = torch.sqrt(torch.clamp(lam, min=1e-30))
    UoS = U / S
    scores = U * S                      # = Xc @ Vt^T (2E, 2E)
    Xl = (X - mean) * mask_l
    scores_l = (Xl @ Xc.T) @ UoS        # the Lien-masked projection

    def _cov(sc, infl, off):
        c = (sc - sc.mean(dim=0)) * infl
        return (c.T @ c) / max(E - 1, 1) + off

    Pm = _cov(scores_l[:E], inflation_factor_bg, offset_bg) * taper
    R = _cov(scores_l[E:], infl_tmp, offset_obs) * taper
    # a singular system (no spread in some components) gives non-finite
    # gains as jnp.linalg.solve does, instead of raising
    K = torch.linalg.solve_ex((Pm + R).T, Pm.T)[0].T
    analysis_pc = scores[:E].T + K @ (scores[E:] - scores[:E]).T
    A = analysis_pc.T @ (UoS.T @ Xc) + mean     # back-transform (E, P)

    # the sampling probability
    if sampling_prob_source == "ensemble":
        w1 = ((A - X[:E]) * mask_l).sum(dim=0)
        w2 = ((X[E:] - X[:E]) * mask_l).sum(dim=0)
        w = torch.where(torch.isclose(w1, w2), 1.0, w1 / w2)
        valid = (w >= 0.0) & (w <= 1.0) & mask_lb
        nvalid = valid.sum()
        prob = torch.where(valid, w, 0.0).sum() / torch.clamp(nvalid, min=1)
        prob = torch.where(nvalid > 0, prob, float("nan"))
    elif sampling_prob_source == "explained_var":
        prob = torch.sum(torch.diagonal(K) * lam / torch.clamp(lam.sum(), min=1e-30))
    else:
        raise ValueError(
            "sampling_prob_source must be 'ensemble' or 'explained_var', "
            f"got {sampling_prob_source}"
        )
    prob = torch.where(torch.isfinite(prob), prob, 1.0)

    samp_new = (1.0 - prob) * samp_prob + prob if use_accum else prob
    accum_new = (1.0 - prob) * accum_prob + prob if ensure_full_nwp_weight else accum_prob

    # the matching target resampled with the dynamic weight
    if iterative_prob_matching:
        res_new = _resample_core(bgf, obsf, 1.0 - samp_new, generator, pick).reshape(bg.shape)
    else:
        res_new = resampled

    out = torch.where(mask_p > 0, A, bgf).reshape(bg.shape)

    # too few rainy boxes: the NWP ensemble, the filter state untouched
    few = idx_prec.sum() <= n2
    return (
        torch.where(few, obs, out),
        torch.where(few, resampled, res_new),
        torch.where(few, samp_prob, samp_new),
        torch.where(few, accum_prob, accum_new),
        torch.where(few, infl_prev, infl_tmp),
        torch.where(few, degrade_t, degrade_new),
    )


class EnsembleKalmanFilter:
    """EnKF update in principal-component space (reference:
    ens_kalman_filter_methods.py:79)."""

    def __init__(self, config, params):
        self._config = config
        kwargs = getattr(params, "combination_kwargs", {}) or {}
        self._inflation_factor_obs_tmp = 1.0
        self._n_tapering = kwargs.get("n_tapering", 0)
        self._non_precip_mask = kwargs.get("non_precip_mask", True)
        self._n_ens_prec = kwargs.get("n_ens_prec", 1)
        self._lien_criterion = kwargs.get("lien_criterion", True)
        self._n_lien = kwargs.get("n_lien", getattr(config, "n_ens_members", 2) // 2)
        self.K = None

    def update(
        self,
        background_ensemble,
        observation_ensemble,
        inflation_factor_bg=1.0,
        inflation_factor_obs=1.0,
        offset_bg=0.0,
        offset_obs=0.0,
        background_ensemble_valid_lien=None,
        observation_ensemble_valid_lien=None,
        device=None,
    ):
        """Kalman update (reference: :105; Nerini 2019 eq. 13-16) of
        (n_ens, n_pc) ensembles.  Returns the analysis ensemble (n_pc,
        n_ens) as the reference does."""
        bg = as_device_tensor(background_ensemble, device, torch.float32)
        obs = as_device_tensor(observation_ensemble, bg.device, torch.float32)
        bg_P = (as_device_tensor(background_ensemble_valid_lien, bg.device, torch.float32)
                if background_ensemble_valid_lien is not None else bg)
        obs_R = (as_device_tensor(observation_ensemble_valid_lien, bg.device, torch.float32)
                 if observation_ensemble_valid_lien is not None else obs)
        P = self.get_covariance_matrix(bg_P, inflation_factor_bg, offset_bg)
        R = self.get_covariance_matrix(obs_R, inflation_factor_obs, offset_obs)
        # eq. 15: K = P (P + R)^-1, solved, not inverted
        self.K = torch.linalg.solve_ex((P + R).T, P.T)[0].T
        return bg.T + self.K @ (obs - bg).T

    def get_covariance_matrix(self, forecast_array, inflation_factor=1.0, offset=0.0):
        """Inflated, offset and tapered covariance (reference: :197;
        Nerini 2019 eq. 13-14)."""
        fa = as_device_tensor(forecast_array, None, torch.float32)
        centered = (fa - fa.mean(dim=0)) * inflation_factor
        cov = centered.T @ centered / max(fa.shape[0] - 1, 1) + offset
        taper = torch.as_tensor(self.get_tapering(fa.shape[1]), dtype=cov.dtype,
                                device=cov.device)
        return cov * taper

    def get_tapering(self, n):
        """Hanning-windowed diagonal taper (reference: :236), host numpy."""
        window = np.eye(n)
        if self._n_tapering > 0:
            hanning_values = np.hanning(self._n_tapering * 2 + 1)[self._n_tapering + 1:]
            for d in range(self._n_tapering):
                window += np.diag(np.ones(n - d - 1) * hanning_values[d], k=d + 1)
                window += np.diag(np.ones(n - d - 1) * hanning_values[d], k=-d - 1)
        return window

    def get_precipitation_mask(self, forecast_array):
        """Grid boxes where at least ``n_ens_prec`` members forecast
        precipitation (all boxes with ``non_precip_mask`` off), as a host
        boolean array."""
        fa = as_device_tensor(forecast_array, None, torch.float32)
        fa = fa.reshape(fa.shape[0], -1)
        if not self._non_precip_mask:
            return np.ones(fa.shape[1], dtype=bool)
        counts = (fa >= self._config.precip_threshold).sum(dim=0)
        return (counts >= self._n_ens_prec).cpu().numpy()

    def get_lien_criterion(self, nwc_ensemble, nwp_ensemble):
        """Grid boxes where at least ``n_lien`` members of both ensembles
        forecast precipitation (Lien et al. 2013; all boxes with
        ``lien_criterion`` off), as a host boolean array."""
        nwc = as_device_tensor(nwc_ensemble, None, torch.float32)
        nwp = as_device_tensor(nwp_ensemble, nwc.device, torch.float32)
        nwc = nwc.reshape(nwc.shape[0], -1)
        nwp = nwp.reshape(nwp.shape[0], -1)
        if not self._lien_criterion:
            return np.ones(nwc.shape[1], dtype=bool)
        thr = self._config.precip_threshold
        ok = ((nwc >= thr).sum(dim=0) >= self._n_lien) & ((nwp >= thr).sum(dim=0) >= self._n_lien)
        return ok.cpu().numpy()

    def get_weighting_for_probability_matching(
        self, background_ensemble, analysis_ensemble, observation_ensemble
    ):
        """Effective NWP weight implied by the analysis update (Nerini 2019
        eq. 17; reference: :359-400): 0 all nowcast, 1 all NWP.  Host
        numpy, as in the reference."""
        bg = to_numpy(background_ensemble)
        w1 = np.sum(to_numpy(analysis_ensemble) - bg, axis=0)
        w2 = np.sum(to_numpy(observation_ensemble) - bg, axis=0)
        w_close = np.isclose(w1, w2)
        w_zero = w_close & np.isclose(w2, 0.0)
        weight = np.zeros_like(w1)
        with np.errstate(divide="ignore", invalid="ignore"):
            weight[~w_zero] = w1[~w_zero] / w2[~w_zero]
        weight[w_close] = 1.0
        valid = (weight >= 0.0) & (weight <= 1.0)
        with np.errstate(invalid="ignore"):
            weight = float(np.nanmean(weight[valid])) if np.any(valid) else np.nan
        if not np.isfinite(weight):
            weight = 1.0
        return weight


class MaskedEnKF(EnsembleKalmanFilter):
    """EnKF with precipitation masking and PCA reduction (reference:
    ens_kalman_filter_methods.py:401).  ``mesh`` in the combination
    kwargs (or the params) shards the PCA fit of :meth:`correct_step`
    (``utils.pca._fit_pca_sharded``); the rest of the filter runs
    replicated on every rank."""

    def __init__(self, config, params):
        super().__init__(config, params)
        kwargs = getattr(params, "combination_kwargs", {}) or {}
        mesh = kwargs.get("mesh")
        self._mesh = mesh if mesh is not None else getattr(params, "mesh", None)
        if self._mesh is not None and not isinstance(self._mesh, DeviceMesh):
            raise TypeError("mesh must be a DeviceMesh (parallel.make_mesh)")
        self._iterative_prob_matching = kwargs.get("iterative_prob_matching", True)
        self._inflation_factor_bg = kwargs.get("inflation_factor_bg", 1.0)
        self._inflation_factor_obs = kwargs.get("inflation_factor_obs", 1.0)
        self._offset_bg = kwargs.get("offset_bg", 0.0)
        self._offset_obs = kwargs.get("offset_obs", 0.0)
        self._sampling_prob_source = kwargs.get("sampling_prob_source", "ensemble")
        self._use_accum_sampling_prob = kwargs.get("use_accum_sampling_prob", False)
        self._ensure_full_nwp_weight = kwargs.get("ensure_full_nwp_weight", True)
        self.sampling_probability = 0.0
        self._accumulated_sampling_prob = 0.0
        self._degradation_timestep = 0.2
        self._inflation_factor_obs_tmp = 1.0

    def get_inflation_factor_obs(self):
        """Effective observation inflation factor; it reaches about 0 when
        the accumulated sampling probability saturates."""
        return self._inflation_factor_obs_tmp

    def correct_step(self, background_ensemble, observation_ensemble,
                     resampled_forecast=None, generator=None, device=None):
        """Rainy-pixel selection, Lien criterion and PCA-reduced Kalman
        update (reference: :452-628) of (n_ens, m, n) ensembles on
        ``background_ensemble``'s device.  Returns ``(analysis,
        resampled)``: the background with the analysis patched into the
        rainy pixels, and the resampled matching target (drawn from
        ``generator``; ``resampled_forecast`` itself when iterative
        probability matching is off or it is None)."""
        from pysteps_tpu_torch.utils.pca import pca_backtransform, pca_transform

        bg = as_device_tensor(background_ensemble, device, torch.float32)
        obs = as_device_tensor(observation_ensemble, bg.device, torch.float32)
        n_ens = bg.shape[0]
        shape2d = bg.shape[1:]
        bg_flat = bg.reshape(n_ens, -1)
        obs_flat = obs.reshape(n_ens, -1)

        # the boxes where either ensemble rains, and the Lien subset of them
        idx_prec = self.get_precipitation_mask(bg_flat) | self.get_precipitation_mask(obs_flat)
        idx_lien = self.get_lien_criterion(bg_flat, obs_flat)[idx_prec]
        idx_prec_t = torch.as_tensor(idx_prec, device=bg.device)

        stacked = torch.cat([bg_flat, obs_flat])[:, idx_prec_t]
        stacked = torch.where(torch.isfinite(stacked), stacked,
                              float(self._config.norain_threshold))

        # too few rainy boxes: fall back to the NWP ensemble
        if int(idx_prec.sum()) <= stacked.shape[0]:
            return obs, resampled_forecast

        stacked_pc, pca_params = pca_transform(stacked, get_params=True,
                                               n_components=stacked.shape[0], mesh=self._mesh)
        stacked_lien_pc = pca_transform(stacked, mask=torch.as_tensor(idx_lien, device=bg.device),
                                        pca_params=pca_params)

        # full-NWP-weight assurance near total NWP trust
        if not np.isclose(self._accumulated_sampling_prob, 1.0, rtol=1e-2):
            self._inflation_factor_obs_tmp = (
                self._inflation_factor_obs
                - self._accumulated_sampling_prob * (self._inflation_factor_obs - 1.0)
            )
        else:
            self._inflation_factor_obs_tmp = np.cos(self._degradation_timestep)
            self._degradation_timestep += 0.2

        analysis_pc = self.update(
            stacked_pc[:n_ens], stacked_pc[n_ens:],
            inflation_factor_bg=self._inflation_factor_bg,
            inflation_factor_obs=self._inflation_factor_obs_tmp,
            offset_bg=self._offset_bg,
            offset_obs=self._offset_obs,
            background_ensemble_valid_lien=stacked_lien_pc[:n_ens],
            observation_ensemble_valid_lien=stacked_lien_pc[n_ens:],
        )
        analysis = pca_backtransform(analysis_pc.T, pca_params)

        if self._sampling_prob_source == "ensemble":
            lien_t = torch.as_tensor(idx_lien, device=bg.device)
            prob = self.get_weighting_for_probability_matching(
                stacked[:n_ens][:, lien_t], analysis[:, lien_t], stacked[n_ens:][:, lien_t])
        elif self._sampling_prob_source == "explained_var":
            ev = pca_params["explained_variance"][: self.K.shape[0]]
            prob = float(torch.sum(torch.diagonal(self.K) * ev))
        else:
            raise ValueError(
                "sampling_prob_source must be 'ensemble' or 'explained_var', "
                f"got {self._sampling_prob_source}"
            )

        if self._use_accum_sampling_prob:
            self.sampling_probability = (1.0 - prob) * self.sampling_probability + prob
        else:
            self.sampling_probability = prob
        if self._ensure_full_nwp_weight:
            self._accumulated_sampling_prob = (
                (1.0 - prob) * self._accumulated_sampling_prob + prob)

        if self._iterative_prob_matching and resampled_forecast is not None:
            if generator is None:
                generator = torch.Generator(device=bg.device).manual_seed(0)
            resampled_forecast = torch.stack([
                probmatching.resample_distributions(
                    bg_flat[j], obs_flat[j], 1.0 - self.sampling_probability,
                    key=generator).reshape(shape2d)
                for j in range(n_ens)
            ])

        out = bg_flat.clone()
        out[:, idx_prec_t] = analysis
        return out.reshape(bg.shape), resampled_forecast
