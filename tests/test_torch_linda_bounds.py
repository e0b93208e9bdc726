"""JAX's own bounds on LINDA (``tests/test_nowcasts_more.py:96-147``) held
on the PyTorch port's forecasts, on that test's 256^2 inputs (9 synthetic
frames, seed 0, velocity (2, 1)): the deterministic forecast with blob
features reaches CSI > 0.5 at 0.1 mm/h on lead 3, the probabilistic one
(5 members, BPS) CRPS < 1.5 with members that differ, the tstorm
features on reflectivity-like inputs give a finite interior and the
domain feature the right shape.  The scores are JAX's."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu.verification import detcatscores as jdetcat  # noqa: E402
from pysteps_tpu.verification import probscores as jprob  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402


@pytest.fixture(scope="module")
def sequence():
    frames = make_synthetic_sequence(n_frames=9, shape=(256, 256), velocity=(2.0, 1.0), seed=0)
    v = np.zeros((2, 256, 256), np.float32)
    v[0], v[1] = 2.0, 1.0
    return frames.astype(np.float32), v


def test_jax_bounds_deterministic_csi(sequence):
    frames, v = sequence
    fc = tnowcasts.get_method("linda")(frames[:3], v, 3, add_perturbations=False,
                                       feature_method="blob", device="cpu").numpy()
    assert fc.shape == (3, 256, 256)
    score = jdetcat.det_cat_fct(fc[-1], frames[5], 0.1, "CSI")
    assert score > 0.5, f"LINDA CSI {score}"


def test_jax_bounds_probabilistic(sequence):
    frames, v = sequence
    fc = tnowcasts.get_method("linda")(frames[:3], v, 3, add_perturbations=True,
                                       n_ens_members=5, seed=42, feature_method="blob",
                                       kmperpixel=1.0, timestep=5, device="cpu").numpy()
    assert fc.shape == (5, 3, 256, 256)
    crps = jprob.CRPS(fc[:, -1], frames[5])
    assert crps < 1.5, f"LINDA CRPS {crps}"
    assert np.nanmax(np.abs(fc[0] - fc[1])) > 0.01


def test_jax_bounds_tstorm_and_domain(sequence):
    frames, v = sequence
    refl = (frames[:3] + 35.0).astype(np.float32)
    fc = tnowcasts.get_method("linda")(
        refl, v, 2, feature_method="tstorm", add_perturbations=False,
        feature_kwargs={"minref": 38, "minmax": 40, "minsize": 20}, device="cpu").numpy()
    assert fc.shape == (2, 256, 256)
    assert np.isfinite(fc[:, 30:-30, 30:-30]).all()
    fc = tnowcasts.get_method("linda")(frames[:3], v, 2, add_perturbations=False,
                                       feature_method="domain", device="cpu")
    assert fc.shape == (2, 256, 256)
