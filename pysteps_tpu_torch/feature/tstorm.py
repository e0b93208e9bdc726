"""Multi-threshold thunderstorm-cell detection (counterpart of
``pysteps_tpu/feature/tstorm.py``; Feldmann et al. 2021).

Host code on numpy and ``scipy.ndimage``, as in the JAX module: h-maxima
by grayscale reconstruction, the watershed breakup by ``watershed_ift``
and a boundary tracer for the contours.  A tensor input is fetched to
the host first.  The cell table is built as a dict of numpy columns;
pandas is imported only where a ``DataFrame`` is returned
(:func:`get_profile` and ``detection(output_feat=False)``), so the
centroids (``output_feat=True``) and the label grid work without it.
"""

import numpy as np
import torch
from scipy import ndimage as ndi

COLUMNS = ("ID", "time", "x", "y", "cen_x", "cen_y", "max_ref", "cont", "area")
SPLIT_MERGE_COLUMNS = (
    "splitted", "split_IDs", "merged", "merged_IDs", "results_from_split", "will_merge",
)


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, float)


def _pandas():
    try:
        import pandas as pd
    except ImportError as err:
        raise ImportError(
            "pandas is needed for the tstorm cell table (DataFrame); "
            "detection(output_feat=True) and the labels work without it"
        ) from err
    return pd


def _h_maxima(image, h, footprint):
    """h-maxima by grayscale reconstruction by dilation."""
    seed = image - h
    mask = image
    rec = seed.copy()
    # iterative geodesic dilation until stable (domains are small)
    for _ in range(512):
        prev = rec
        rec = np.minimum(ndi.grey_dilation(rec, footprint=footprint), mask)
        if np.allclose(rec, prev):
            break
    return ((image - rec) >= h).astype(np.uint8)


def _watershed(ref, markers):
    """Marker-based watershed on -ref by ``watershed_ift``."""
    ref_norm = ref - np.nanmin(ref)
    denom = max(np.nanmax(ref_norm), 1e-6)
    inverted = (255 - 255 * ref_norm / denom).astype(np.uint16)
    return ndi.watershed_ift(inverted.astype(np.uint16), markers.astype(np.int32))


def _find_contours(binary):
    """Boundary pixels of a binary region as an (N, 2) array of (row, col)
    coordinates."""
    eroded = ndi.binary_erosion(binary)
    boundary = binary.astype(bool) & ~eroded
    coords = np.argwhere(boundary)
    return [coords.astype(float)] if coords.size else []


def longdistance(loc_max, mindis):
    """Drop maxima closer than ``mindis`` to an earlier maximum."""
    y_max = np.asarray(loc_max[0])
    x_max = np.asarray(loc_max[1])
    n = 0
    while n < len(y_max):
        dis = np.sqrt((x_max[n] - x_max) ** 2 + (y_max[n] - y_max) ** 2)
        close = np.where(dis < mindis)[0]
        close = close[close > n]
        if len(close) > 0:
            x_max = np.delete(x_max, close)
            y_max = np.delete(y_max, close)
        n += 1
    return y_max, x_max


def breakup(ref, minval, maxima):
    """Watershed segmentation into one area per maximum."""
    ref_t = np.full(ref.shape, minval)
    ref_t[ref > minval] = ref[ref > minval]
    markers = ndi.label(maxima)[0]
    areas = _watershed(np.nan_to_num(ref_t, nan=minval), markers)
    return areas, areas


def _object_column(values):
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


def _profile(areas, binary, ref, loc_max, time, output_splits_merges=False):
    """The cell table as a dict of numpy columns, and the label grid."""
    cells = areas * binary
    cell_labels = cells[loc_max]
    labels = np.zeros(cells.shape)
    rows = {c: [] for c in COLUMNS}
    for n, cell_label in enumerate(cell_labels):
        if cell_label == 0:
            continue
        this_id = n + 1
        ys, xs = np.where(cells == cell_label)
        cell_unique = (cells == cell_label).astype(float)
        for key, value in (
                ("ID", this_id), ("time", time), ("x", xs), ("y", ys),
                ("cen_x", int(np.round(np.nanmean(xs)))),
                ("cen_y", int(np.round(np.nanmean(ys)))),
                ("max_ref", np.nanmax(ref[ys, xs])),
                ("cont", _find_contours(cell_unique)), ("area", len(xs))):
            rows[key].append(value)
        labels[cells == cell_label] = this_id
    table = {
        "ID": np.asarray(rows["ID"], dtype=np.int64),
        "time": _object_column(rows["time"]),
        "x": _object_column(rows["x"]),
        "y": _object_column(rows["y"]),
        "cen_x": np.asarray(rows["cen_x"], dtype=np.int64),
        "cen_y": np.asarray(rows["cen_y"], dtype=np.int64),
        "max_ref": np.asarray(rows["max_ref"], dtype=float),
        "cont": _object_column(rows["cont"]),
        "area": np.asarray(rows["area"], dtype=np.int64),
    }
    if output_splits_merges:
        for key in SPLIT_MERGE_COLUMNS:
            table[key] = np.full(len(table["ID"]), None, dtype=object)
    return table, labels


def _frame(table, output_splits_merges=False):
    """The cell table as the JAX module's ``DataFrame``: one row a cell,
    built from rows so that pandas infers the same column types."""
    pd = _pandas()
    columns = list(COLUMNS) + (list(SPLIT_MERGE_COLUMNS) if output_splits_merges else [])
    rows = [{c: table[c][i] for c in columns} for i in range(len(table["ID"]))]
    for row in rows:
        for c in ("ID", "cen_x", "cen_y", "area"):
            row[c] = int(row[c])
    df = pd.DataFrame(rows, columns=columns)
    if output_splits_merges and len(df):
        df["split_IDs"] = df["split_IDs"].astype("object")
        df["merged_IDs"] = df["merged_IDs"].astype("object")
    return df


def get_profile(areas, binary, ref, loc_max, time, minref, output_splits_merges=False):
    """The cell properties ``DataFrame`` and the label grid (needs pandas)."""
    table, labels = _profile(areas, binary, ref, loc_max, time, output_splits_merges)
    return _frame(table, output_splits_merges), labels


def _detect(input_image, minref=35, maxref=48, mindiff=6, minsize=50, minmax=41,
            mindis=10, output_splits_merges=False, time="000000000"):
    """The cell table (dict of numpy columns) and the label grid."""
    input_image = _host(input_image)
    filt_image = np.zeros(input_image.shape)
    wet = input_image >= minref
    filt_image[wet] = input_image[wet]
    filt_image[input_image > maxref] = maxref

    # saturated cores count as maxima
    max_image = np.zeros(filt_image.shape)
    max_image[filt_image == maxref] = 1
    labels_sat, n_groups = ndi.label(max_image)
    for n in range(1, n_groups + 1):
        indx, indy = np.where(labels_sat == n)
        if len(indx) > 3:
            max_image[indx[0], indy[0]] = 2
    filt_image[max_image == 2] = maxref + 1

    binary = (filt_image > 0).astype(float)
    labels, n_groups = ndi.label(binary)
    for n in range(1, n_groups + 1):
        ind = np.where(labels == n)
        maxval = np.nanmax(input_image[ind])
        if len(ind[0]) < minsize or maxval < minmax:
            binary[labels == n] = 0
            labels[labels == n] = 0
    filt_image = filt_image * binary

    elem = mindis - 1 if mindis % 2 == 0 else mindis
    struct = np.ones((elem, elem))
    if np.nanmax(filt_image) < minref:
        maxima = np.zeros(filt_image.shape)
    else:
        maxima = _h_maxima(filt_image, mindiff, struct)
    loc_max = np.where(maxima > 0)
    loc_max = longdistance(loc_max, mindis)

    # discard regions without a maximum
    i_cell = labels[loc_max]
    for n in np.unique(labels)[1:]:
        if n not in i_cell:
            binary[labels == n] = 0
            labels[labels == n] = 0

    maxima_dis = np.zeros(maxima.shape)
    maxima_dis[loc_max] = 1
    areas, _ = breakup(input_image, float(np.nanmin(input_image)), maxima_dis)
    return _profile(areas, binary, input_image, loc_max, time, output_splits_merges)


def detection(input_image, max_num_features=None, minref=35, maxref=48, mindiff=6,
              minsize=50, minmax=41, mindis=10, output_feat=False,
              output_splits_merges=False, time="000000000", **kwargs):
    """Multi-threshold cell detection: (cells ``DataFrame``, labels), or
    with ``output_feat`` the (N, 2) (x, y) centroids, largest cells first
    when ``max_num_features`` is given."""
    table, labels_out = _detect(
        input_image, minref=minref, maxref=maxref, mindiff=mindiff, minsize=minsize,
        minmax=minmax, mindis=mindis, output_splits_merges=output_splits_merges, time=time,
    )
    n_cells = len(table["ID"])
    idx = (
        np.argsort(table["area"])[::-1]
        if max_num_features is not None and n_cells
        else None
    )
    if not output_feat:
        cells_id = _frame(table, output_splits_merges)
        if idx is None:
            return cells_id, labels_out
        for i in idx[max_num_features:]:
            labels_out[labels_out == table["ID"][i]] = 0
        return cells_id.iloc[idx[:max_num_features]], labels_out
    if not n_cells:
        return np.zeros((0, 2))
    out = np.column_stack([table["cen_x"], table["cen_y"]])
    if idx is not None:
        out = out[idx[:max_num_features]]
    return out
