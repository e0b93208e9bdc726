"""DATing thunderstorm tracking and the tracking registry of the PyTorch
port against the JAX package's, on the inputs of
``tests/test_feature_tracking.py::test_tdating_tracks_moving_storm`` (one
storm moving (5, 3) px a frame at 128^2) and on two storms that merge:
the label grids of every frame equal, the cell tables' IDs, centroids and
areas equal, the tracks equal.  The port's Lucas-Kanade flow runs on the
CPU (``device="cpu"``); the cells move by whole pixels of its mean flow,
so the flows' differences (under 1e-3 px) do not show."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_feature_tracking import _storm_field  # noqa: E402

from pysteps_tpu import tracking as jtracking  # noqa: E402
from pysteps_tpu.tracking import tdating as jdating  # noqa: E402
from pysteps_tpu_torch import tracking as ttracking  # noqa: E402
from pysteps_tpu_torch.tracking import tdating as tdating  # noqa: E402

COLS = ["ID", "cen_x", "cen_y", "area"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its many small operators run
    no faster on more, and threads that wait spinning slow the other test
    workers sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moving_storm():
    frames = [_storm_field([(40 + 3 * t, 40 + 5 * t)], shape=(128, 128), peak=50.0)
              for t in range(5)]
    return np.stack(frames), [f"t{t}" for t in range(5)], dict(mintrack=2, minsize=10)


def _merging_storms():
    frames = [_storm_field([(40 + 4 * t, 30 + 6 * t), (80 - 4 * t, 40 + 5 * t)],
                           shape=(128, 128), peak=50.0, scale=7.0) for t in range(6)]
    return (np.stack(frames), [f"t{t}" for t in range(6)],
            dict(mintrack=2, minsize=10, output_splits_merges=True))


@pytest.fixture(scope="module")
def runs():
    video, times, kw = _moving_storm()
    return jdating.dating(video, times, **kw), tdating.dating(video, times, device="cpu", **kw)


def test_tdating_labels_cells_and_tracks(runs):
    (tracks_j, cells_j, labels_j), (tracks_t, cells_t, labels_t) = runs
    assert len(labels_t) == len(labels_j)
    for a, b in zip(labels_t, labels_j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(cells_t, cells_j):
        assert list(a.columns) == list(b.columns)
        np.testing.assert_array_equal(a[COLS].to_numpy(), b[COLS].to_numpy())
    assert len(tracks_t) == len(tracks_j) >= 1
    for a, b in zip(tracks_t, tracks_j):
        np.testing.assert_array_equal(a[COLS].to_numpy(), b[COLS].to_numpy())
        assert list(a.time) == list(b.time)


def test_tdating_test_feature_tracking_bound(runs):
    tracks_t = runs[1][0]
    assert len(tracks_t) >= 1
    assert max(len(t) for t in tracks_t) >= 2


def test_advect_and_match_steps():
    video, times, kw = _moving_storm()
    from pysteps_tpu.feature import tstorm as jtstorm
    from pysteps_tpu_torch.feature import tstorm as ttstorm

    cells, labels = jtstorm.detection(video[1], minsize=10)
    cells_t, _ = ttstorm.detection(video[1], minsize=10)
    nxt, nlabels = jtstorm.detection(video[2], minsize=10)
    flow = np.zeros((2, 128, 128))
    flow[0], flow[1] = 5.2, 2.8
    ad_j = jdating.advect(cells, nlabels, flow)
    ad_t = tdating.advect(cells_t, nlabels, flow)
    for col in ("ID", "cen_x", "cen_y", "flowx", "flowy"):
        assert list(ad_t[col]) == list(ad_j[col])
    ov_j = jdating.match(ad_j, nlabels)
    ov_t = tdating.match(ad_t, nlabels)
    assert list(ov_t[0].t_ID) == list(ov_j[0].t_ID)
    assert list(ov_t[0].frac) == list(ov_j[0].frac)


def test_tracking_steps_with_splits_and_merges():
    """Two storms that merge, tracked step by step with a given flow:
    the new IDs, labels and merge records equal JAX's."""
    from pysteps_tpu.feature import tstorm as jtstorm
    from pysteps_tpu_torch.feature import tstorm as ttstorm

    video, times, kw = _merging_storms()
    flow = np.zeros((2, 128, 128))
    flow[0], flow[1] = 5.5, 0.0
    kw_det = dict(minsize=10, output_splits_merges=True)
    prev_j, _ = jtstorm.detection(video[0], **kw_det)
    prev_t, _ = ttstorm.detection(video[0], **kw_det)
    max_j = max_t = 3
    merged = 0
    for t in range(1, len(video)):
        cells_j, labels_j = jtstorm.detection(video[t], **kw_det)
        cells_t, labels_t = ttstorm.detection(video[t], **kw_det)
        out_j = jdating.tracking(cells_j, prev_j, labels_j, flow, max_j, output_splits_merges=True)
        out_t = tdating.tracking(cells_t, prev_t, labels_t, flow, max_t, output_splits_merges=True)
        assert out_t[1] == out_j[1]
        np.testing.assert_array_equal(out_t[2], out_j[2])
        np.testing.assert_array_equal(out_t[0][COLS].to_numpy(), out_j[0][COLS].to_numpy())
        assert [str(x) for x in out_t[0].merged_IDs] == [str(x) for x in out_j[0].merged_IDs]
        merged += int(out_j[0].merged.eq(True).sum())
        prev_j, prev_t, max_j, max_t = out_j[0], out_t[0], out_j[1], out_t[1]
    assert merged >= 1


def test_dating_errors():
    video, times, _ = _moving_storm()
    for kw in (dict(cell_list=[1], label_list=[]), dict(start=9)):
        with pytest.raises(ValueError) as ej:
            jdating.dating(video, times, **kw)
        with pytest.raises(ValueError) as et:
            tdating.dating(video, times, device="cpu", **kw)
        assert str(et.value) == str(ej.value)


def test_tracking_registry_equals_jax():
    for name in ("lucaskanade", "LucasKanade", "tdating"):
        j, t = jtracking.get_method(name), ttracking.get_method(name)
        assert t.__module__.replace("pysteps_tpu_torch", "pysteps_tpu") == j.__module__
        assert t.__name__ == j.__name__
    for name in ("dating", None):
        with pytest.raises(ValueError) as ej:
            jtracking.get_method(name)
        with pytest.raises(ValueError) as et:
            ttracking.get_method(name)
        assert str(et.value) == str(ej.value)
