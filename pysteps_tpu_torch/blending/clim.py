"""
Climatological skill store (counterpart of ``pysteps_tpu/blending/clim.py``).

Rolling-window daily NWP skill persisted as NPY/PKL files in the working
directory — the blending weights' regression target.
"""

import pickle
from pathlib import Path

import numpy as np


def get_default_skill(n_cascade_levels=6, n_models=1):
    """Default climatological skill from BPS2006
    (reference: clim.py:25)."""
    default_skill = np.array(
        [0.848, 0.537, 0.237, 0.065, 0.020, 0.0044, 0.0052, 0.0040]
    )
    n_skill = default_skill.shape[0]
    if n_cascade_levels < n_skill:
        default_skill = default_skill[:n_cascade_levels]
    elif n_cascade_levels > n_skill:
        default_skill = np.append(
            default_skill, np.repeat(1e-4, n_cascade_levels - n_skill)
        )
    return np.resize(default_skill, (n_models, n_cascade_levels))


def save_skill(current_skill, validtime, outdir_path, window_length=30, **kwargs):
    """Update today's running-average skill; roll the daily window at a day
    boundary (reference: clim.py:59)."""
    outdir = Path(outdir_path)
    outdir.mkdir(parents=True, exist_ok=True)
    skill_today_file = outdir / "NWP_skill_today.pkl"
    past_skill_file = outdir / "NWP_skill_window.npy"

    skill_today = None
    if skill_today_file.is_file():
        with open(skill_today_file, "rb") as f:
            skill_today = pickle.load(f)
        if skill_today["mean_skill"].shape != current_skill.shape:
            skill_today = None
    if skill_today is None:
        skill_today = {
            "mean_skill": np.copy(current_skill),
            "n": 0,
            "last_validtime": validtime,
        }

    if skill_today["last_validtime"].date() < validtime.date():
        # day rolled over: append yesterday's mean to the window
        past_skill = (
            np.load(past_skill_file) if past_skill_file.is_file() else None
        )
        daily = skill_today["mean_skill"][None]
        if past_skill is None or past_skill.shape[1:] != daily.shape[1:]:
            past_skill = daily
        else:
            past_skill = np.concatenate([past_skill, daily])[-window_length:]
        np.save(past_skill_file, past_skill)
        skill_today = {
            "mean_skill": np.copy(current_skill),
            "n": 1,
            "last_validtime": validtime,
        }
    else:
        n = skill_today["n"]
        skill_today["mean_skill"] = (
            skill_today["mean_skill"] * n + current_skill
        ) / (n + 1)
        skill_today["n"] = n + 1
        skill_today["last_validtime"] = validtime

    with open(skill_today_file, "wb") as f:
        pickle.dump(skill_today, f)


def calc_clim_skill(outdir_path, n_cascade_levels=6, n_models=1, window_length=30):
    """Geometric-mean climatological skill over the rolling window
    (reference: clim.py:158)."""
    past_skill_file = Path(outdir_path) / "NWP_skill_window.npy"
    past_skill = np.load(past_skill_file) if past_skill_file.is_file() else np.array(None)
    if not past_skill.any():
        print("WARNING: Past skill file is empty, using default BPS2006 skill")
        return get_default_skill(n_cascade_levels, n_models)
    if past_skill.shape[0] < window_length:
        print(
            f"WARNING: Past skill file has fewer days ({past_skill.shape[0]}) "
            f"than expected ({window_length}). Using default BPS2006 skill"
        )
        return get_default_skill(n_cascade_levels, n_models)
    past_skill = past_skill[-window_length:]
    past_skill = np.where(past_skill < 10e-5, 10e-5, past_skill)
    geomean = np.exp(np.log(past_skill).mean(axis=0))
    geomean = np.where(geomean < 10e-5, 10e-5, geomean)
    return np.nan_to_num(geomean, nan=10e-5, posinf=10e-5, neginf=10e-5)
