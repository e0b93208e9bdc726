"""Shi-Tomasi corners (``pysteps_tpu_torch/feature/shitomasi.py``) and
pyramidal Lucas-Kanade tracking (``pysteps_tpu_torch/tracking/
lucaskanade.py``) against the JAX package on the CPU.

Inputs: the synthetic dB sequence of ``tests/helpers.py`` at 128^2
(velocity (2, 1), seed 3; NaNs added where said), whose K-th corner
score is not tied.  ``torch.topk`` and ``jax.lax.top_k`` may order equal
scores otherwise, so corners are compared as sets.  Tolerances: equal
corner sets; pyramids and patch matrices within 1e-5 of the largest
value; tracked displacements within 1e-3 px of JAX's.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu.feature import shitomasi as jst  # noqa: E402
from pysteps_tpu.tracking import lucaskanade as jlk  # noqa: E402
from pysteps_tpu_torch.feature import shitomasi as tst  # noqa: E402
from pysteps_tpu_torch.ops import conv as tconv  # noqa: E402
from pysteps_tpu_torch.tracking import lucaskanade as tlk  # noqa: E402

PX_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch calls: the tier-1 run
    shares the machine's cores among its workers, and a pool of one thread
    a core in each worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    f = make_synthetic_sequence(n_frames=3, shape=(128, 128), velocity=(2.0, 1.0), seed=3)
    return (10.0 * np.log10(np.maximum(f, 0.1))).astype(np.float32)


def _set(points):
    return set(map(tuple, np.asarray(points).tolist()))


def _close(out, ref, rtol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rtol * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("kw", [{}, {"max_corners": 20}, {"min_distance": 4, "block_size": 4},
                                {"buffer_mask": 0}, {"use_cmask": False, "quality_level": 0.1}])
def test_detection_corner_sets(frames, kw):
    img = frames[0].copy()
    img[:, :6] = np.nan
    out = tst.detection(img, device="cpu", **kw)
    ref = jst.detection(img, **kw)
    assert out.shape[1] == 2 and out.shape[0] > 5
    assert _set(out) == _set(ref)


def test_k_th_score_not_tied(frames):
    """The inputs of the cut above: the 20th and 21st peak scores of the
    first frame (the port's structure tensor) differ."""
    img = torch.tensor(frames[0])
    gx, gy = tst._sobel(img)
    Axx, Axy, Ayy = (tst._box_filter(a, 5) for a in (gx * gx, gx * gy, gy * gy))
    score = (Axx + Ayy) / 2 - torch.sqrt(((Axx - Ayy) / 2) ** 2 + Axy**2)
    peak = (score >= tconv.pool_same(score, 21, "max")) & (score > 0.01 * score.max())
    top = torch.sort(score[peak], descending=True).values
    assert top.numel() > 21 and float(top[19]) != float(top[20])


def test_detection_batch_and_mask(frames):
    out = tst.detection_batch(frames, max_corners=50, device="cpu")
    ref = jst.detection_batch(frames, max_corners=50)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert _set(a) == _set(b)
    pts, mask, scores = tst.detection(frames[0], return_mask_and_scores=True, device="cpu")
    assert mask.shape == frames[0].shape and scores is None


def test_build_pyramid(frames):
    out = tlk.build_pyramid(torch.tensor(frames[0]), 3)
    ref = jlk.build_pyramid(jnp.asarray(frames[0]), 3)
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        _close(o, r)


def test_patch_and_window_matrices(frames):
    rng = np.random.default_rng(0)
    px = rng.uniform(0, 127, 7).astype(np.float32)
    py = rng.uniform(0, 127, 7).astype(np.float32)
    imgs = frames[:2]
    _close(tlk._extract_patches(torch.tensor(imgs), torch.tensor(px), torch.tensor(py), 9),
           jlk._extract_patches(jnp.asarray(imgs), jnp.asarray(px), jnp.asarray(py), 9))
    v = rng.uniform(-4, 4, 7).astype(np.float32)
    _close(tlk._window_matrices(torch.tensor(v), 5, 11),
           jlk._window_matrices(jnp.asarray(v), 5, 11))


def test_rescale255(frames):
    img = frames[0].copy()
    img[3, 3] = np.nan
    _close(tlk._rescale255(torch.tensor(img)), jlk._rescale255(jnp.asarray(img)))


@pytest.mark.parametrize("kw", [{}, {"winsize": (20, 20), "nr_levels": 2},
                                {"criteria": (3, 8, 0)}])
def test_track_features(frames, kw):
    pts = jst.detection(frames[0], max_corners=60)
    xy, uv = tlk.track_features(frames[0], frames[1], pts, device="cpu", **kw)
    jxy, juv = jlk.track_features(frames[0], frames[1], pts, **kw)
    np.testing.assert_array_equal(xy, jxy)
    assert np.abs(uv - juv).max() <= PX_TOL
    assert np.abs(np.median(uv, axis=0) - [2.0, 1.0]).max() < 0.5


def test_track_features_batch(frames):
    points = [jst.detection(f, max_corners=40) for f in frames[:2]]
    points.append(np.zeros((0, 2), np.float32))
    prvs, nxt = frames[[0, 1, 0]], frames[[1, 2, 1]]
    out = tlk.track_features_batch(prvs, nxt, points, device="cpu")
    ref = jlk.track_features_batch(prvs[:2], nxt[:2], points[:2])
    for (xy, uv), (jxy, juv) in zip(out, ref):
        np.testing.assert_array_equal(xy, jxy)
        assert np.abs(uv - juv).max() <= PX_TOL
    assert out[2][0].shape == (0, 2)


def test_track_features_without_points(frames):
    xy, uv = tlk.track_features(frames[0], frames[1], np.zeros((0, 2)), device="cpu")
    assert xy.shape == uv.shape == (0, 2)
