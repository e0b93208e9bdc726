"""SAL (structure, amplitude, location) spatial verification (counterpart
of ``pysteps_tpu/verification/salscores.py``; Wernli et al. 2008).

Host code, as in the JAX module: objects are the labels of the port's
tstorm detector (no pandas needed), and their sums, maxima and weighted
centroids are computed from the label grid.  Tensor inputs are fetched
to the host first.
"""

from math import hypot, sqrt

import numpy as np
import torch
from scipy.ndimage import center_of_mass

from pysteps_tpu_torch.feature import tstorm as tstorm_detect

# the object properties computed for each detected feature
REGIONPROPS = ["label", "weighted_centroid", "max_intensity", "intensity_image"]


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def sal(prediction, observation, thr_factor=0.067, thr_quantile=0.95, tstorm_kwargs=None):
    """The SAL triple (structure, amplitude, location)."""
    structure = sal_structure(prediction, observation, thr_factor, thr_quantile, tstorm_kwargs)
    amplitude = sal_amplitude(prediction, observation)
    location = sal_location(prediction, observation, thr_factor, thr_quantile, tstorm_kwargs)
    return structure, amplitude, location


def _detect_objects(precip, thr_factor, thr_quantile, tstorm_kwargs):
    """The objects of ``precip`` with their intensity sums, maxima and
    weighted centroids."""
    if thr_factor is not None and thr_quantile is None:
        raise ValueError("You must pass thr_quantile, too")
    precip = _host(precip)
    tstorm_kwargs = dict(tstorm_kwargs or {})
    if thr_factor is not None:
        zero_value = np.nanmin(precip)
        wet = precip[precip > zero_value]
        if wet.size == 0:
            return []
        threshold = thr_factor * np.nanquantile(wet, thr_quantile)
        tstorm_kwargs = {
            "minmax": tstorm_kwargs.get("minmax", threshold),
            "maxref": tstorm_kwargs.get("maxref", threshold + 1e-5),
            "mindiff": tstorm_kwargs.get("mindiff", 1e-5),
            "minref": tstorm_kwargs.get("minref", threshold),
            "minsize": tstorm_kwargs.get("minsize", 4),
        }
    _, labels = tstorm_detect._detect(np.nan_to_num(precip), **tstorm_kwargs)
    labels = labels.astype(int)
    objects = []
    for lbl in np.unique(labels):
        if lbl == 0:
            continue
        ys, xs = np.where(labels == lbl)
        vals = np.nan_to_num(precip[ys, xs])
        s = vals.sum()
        if s <= 0:
            continue
        objects.append(
            {
                "sum": s,
                "max": vals.max(),
                "centroid": (float((ys * vals).sum() / s), float((xs * vals).sum() / s)),
            }
        )
    return objects


def _scaled_volume(objects):
    """The objects' total scaled volume."""
    if not objects:
        return 0.0
    vols = [o["sum"] * (o["sum"] / o["max"]) for o in objects]
    sums = [o["sum"] for o in objects]
    return float(np.nansum(vols) / np.nansum(sums))


def sal_structure(prediction, observation, thr_factor=None, thr_quantile=None,
                  tstorm_kwargs=None):
    """The structure component, in [-2, 2]."""
    pred_obj = _detect_objects(prediction, thr_factor, thr_quantile, tstorm_kwargs)
    obs_obj = _detect_objects(observation, thr_factor, thr_quantile, tstorm_kwargs)
    if not pred_obj or not obs_obj:
        return np.nan
    vp = _scaled_volume(pred_obj)
    vo = _scaled_volume(obs_obj)
    return float((vp - vo) / (0.5 * (vp + vo)))


def sal_amplitude(prediction, observation):
    """The amplitude component, in [-2, 2]."""
    mean_pred = np.nanmean(_host(prediction))
    mean_obs = np.nanmean(_host(observation))
    return float((mean_pred - mean_obs) / (0.5 * (mean_pred + mean_obs)))


def sal_location(prediction, observation, thr_factor=None, thr_quantile=None,
                 tstorm_kwargs=None):
    """The location component, in [0, 2]."""
    return _l1_param(prediction, observation) + _l2_param(
        prediction, observation, thr_factor, thr_quantile, tstorm_kwargs
    )


def _l1_param(prediction, observation):
    observation, prediction = _host(observation), _host(prediction)
    max_dist = sqrt(observation.shape[0] ** 2 + observation.shape[1] ** 2)
    obi = center_of_mass(np.nan_to_num(observation))
    fori = center_of_mass(np.nan_to_num(prediction))
    return hypot(fori[1] - obi[1], fori[0] - obi[0]) / max_dist


def _weighted_distance(precip, thr_factor, thr_quantile, tstorm_kwargs):
    precip = _host(precip)
    objects = _detect_objects(precip, thr_factor, thr_quantile, tstorm_kwargs)
    if not objects:
        return np.nan
    centroid_total = center_of_mass(np.nan_to_num(precip))
    sum_dist = 0.0
    sum_p = 0.0
    for o in objects:
        d = hypot(o["centroid"][1] - centroid_total[1], o["centroid"][0] - centroid_total[0])
        sum_dist += o["sum"] * d
        sum_p += o["sum"]
    return sum_dist / sum_p


def _l2_param(prediction, observation, thr_factor, thr_quantile, tstorm_kwargs):
    observation = _host(observation)
    max_dist = sqrt(observation.shape[0] ** 2 + observation.shape[1] ** 2)
    obs_r = _weighted_distance(observation, thr_factor, thr_quantile, tstorm_kwargs)
    forc_r = _weighted_distance(prediction, thr_factor, thr_quantile, tstorm_kwargs)
    return float(2 * abs(obs_r - forc_r) / max_dist)
