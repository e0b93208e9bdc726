"""DATing thunderstorm detection and tracking (counterpart of
``pysteps_tpu/tracking/tdating.py``; Feldmann et al. 2021).

Host code over pandas, as in the JAX module: per-frame tstorm detection,
cell advection with the Lucas-Kanade flow, overlap matching (match,
split and merge fractions) and track assembly.  The flow runs on the
run's device (``device``: the card unless the caller asks for the CPU);
pandas is imported when a table is built.
"""

import numpy as np

from pysteps_tpu_torch import motion
from pysteps_tpu_torch.feature import tstorm as tstorm_detect


def _no_id(cell_id):
    return cell_id == 0 or (isinstance(cell_id, float) and np.isnan(cell_id))


def advect(cells_id, labels, V1, output_splits_merges=False):
    """Advect the detected cells with their mean flow."""
    pd = tstorm_detect._pandas()
    columns = [
        "ID", "x", "y", "cen_x", "cen_y", "max_ref", "cont", "t_ID",
        "frac", "flowx", "flowy",
    ]
    if output_splits_merges:
        columns += ["splitted", "split_IDs", "split_fracs"]
    cells_ad = pd.DataFrame(data=None, index=range(len(cells_id)), columns=columns)
    for idx, cell in cells_id.iterrows():
        if _no_id(cell.ID):
            continue
        ad_x = int(np.round(np.nanmean(V1[0, cell.y, cell.x])))
        ad_y = int(np.round(np.nanmean(V1[1, cell.y, cell.x])))
        new_x = np.clip(cell.x + ad_x, 0, labels.shape[1] - 1)
        new_y = np.clip(cell.y + ad_y, 0, labels.shape[0] - 1)
        cells_ad.at[idx, "x"] = new_x
        cells_ad.at[idx, "y"] = new_y
        cells_ad.at[idx, "flowx"] = ad_x
        cells_ad.at[idx, "flowy"] = ad_y
        cells_ad.at[idx, "cen_x"] = cell.cen_x + ad_x
        cells_ad.at[idx, "cen_y"] = cell.cen_y + ad_y
        cells_ad.at[idx, "ID"] = cell.ID
        cell_unique = np.zeros(labels.shape)
        cell_unique[new_y, new_x] = 1
        cells_ad.at[idx, "cont"] = tstorm_detect._find_contours(cell_unique)
    return cells_ad


def match(cells_ad, labels, match_frac=0.4, split_frac=0.1, output_splits_merges=False):
    """Overlap-match the advected cells to the new detections."""
    cells_ov = cells_ad.copy()
    possible_merge_ids = {i: [] for i in np.unique(labels)}
    for ID_a, cell_a in cells_ov.iterrows():
        if _no_id(cell_a.ID):
            continue
        ID_vec = labels[cell_a.y, cell_a.x]
        IDs = np.unique(ID_vec)
        IDs = IDs[IDs != 0]
        if len(IDs) == 0:
            cells_ov.at[ID_a, "t_ID"] = 0
            continue
        for i in IDs:
            possible_merge_ids[i].append(cell_a.ID)
        N = np.array([np.sum(ID_vec == i) for i in IDs], float)
        if output_splits_merges:
            valid = (N / len(ID_vec)) > split_frac
            if valid.sum() > 1:
                cells_ov.at[ID_a, "splitted"] = True
                cells_ov.at[ID_a, "split_IDs"] = IDs[valid].tolist()
                cells_ov.at[ID_a, "split_fracs"] = (N / len(ID_vec)).tolist()
        m = int(np.argmax(N))
        coverage = N[m] / len(ID_vec)
        cells_ov.at[ID_a, "t_ID"] = IDs[m] if coverage >= match_frac else 0
        cells_ov.at[ID_a, "frac"] = coverage
    return cells_ov, labels, possible_merge_ids


def tracking(cells_id, cells_id_prev, labels, V1, max_ID, match_frac=0.4, merge_frac=0.1,
             split_frac=0.1, output_splits_merges=False):
    """One tracking step: advect, overlap, match the IDs."""
    cells_id_new = cells_id.copy()
    cells_ad = advect(cells_id_prev, labels, V1, output_splits_merges)
    cells_ov, labels, possible_merge_ids = match(
        cells_ad, labels, match_frac=match_frac, split_frac=split_frac,
        output_splits_merges=output_splits_merges,
    )
    splitted_cells = (
        cells_ov[cells_ov.splitted == True]  # noqa: E712
        if output_splits_merges
        else None
    )

    newlabels = np.zeros(labels.shape)
    merge_candidates = {}
    for index, cell in cells_id_new.iterrows():
        if _no_id(cell.ID):
            continue
        matches = cells_ov[cells_ov.t_ID == cell.ID]
        if len(matches) > 0:
            sizes = [len(x) for x in matches.x]
            new_ID = matches.ID.values[int(np.argmax(sizes))]
        else:
            max_ID += 1
            new_ID = max_ID
        cells_id_new.loc[index, "ID"] = new_ID
        newlabels[labels == index + 1] = new_ID
        merge_candidates[new_ID] = possible_merge_ids.get(cell.ID, [])

    if output_splits_merges:
        for target_id, possible_IDs in merge_candidates.items():
            merge_ids = []
            for p_id in possible_IDs:
                cell_a = cells_ad[cells_ad.ID == p_id]
                if len(cell_a) != 1:
                    continue
                ID_vec = newlabels[cell_a.y.item(), cell_a.x.item()]
                if np.sum(ID_vec == target_id) / len(ID_vec) > merge_frac:
                    merge_ids.append(p_id)
            if len(merge_ids) > 1:
                sel = cells_id_new[cells_id_new.ID == target_id]
                if len(sel):
                    cid = sel.index[0]
                    cells_id_new.at[cid, "merged"] = True
                    cells_id_new.at[cid, "merged_IDs"] = merge_ids

    return cells_id_new, max_ID, newlabels, splitted_cells


def couple_track(cell_list, max_ID, mintrack):
    """Re-arrange the cells of each time into one track per ID."""
    pd = tstorm_detect._pandas()
    track_list = []
    for n in range(1, max_ID):
        parts = [frame[frame.ID == n] for frame in cell_list]
        track = pd.concat(parts, axis=0) if parts else pd.DataFrame()
        if len(track) < mintrack:
            continue
        track_list.append(track)
    return track_list


def dating(input_video, timelist, mintrack=3, cell_list=None, label_list=None, start=0,
           minref=35, maxref=48, mindiff=6, minsize=50, minmax=41, mindis=10,
           dyn_thresh=False, match_frac=0.4, split_frac=0.1, merge_frac=0.1,
           output_splits_merges=False, device=None):
    """The DATing pipeline over a (T, m, n) reflectivity sequence:
    (track_list, cell_list, label_list).  The Lucas-Kanade flow runs on
    ``device`` (a tensor's own device, else the card unless "cpu")."""
    if cell_list is None or label_list is None:
        cell_list, label_list = [], []
    elif len(cell_list) != len(label_list):
        raise ValueError("len(cell_list) != len(label_list)")
    if start > len(timelist):
        raise ValueError("start > len(timelist)")

    oflow_method = motion.get_method("LK")
    max_ID = (
        0 if len(label_list) == 0
        else int(np.nanmax([np.nanmax(np.unique(label_list)), 0]))
    )
    for t in range(start, len(timelist)):
        cells_id, labels = tstorm_detect.detection(
            input_video[t], minref=minref, maxref=maxref, mindiff=mindiff,
            minsize=minsize, minmax=minmax, mindis=mindis, time=timelist[t],
            output_splits_merges=output_splits_merges,
        )
        if len(cell_list) < 2:
            cell_list.append(cells_id)
            label_list.append(labels)
            max_ID = int(np.nanmax([np.nanmax(labels), max_ID]) + 1)
            continue
        if t >= 2:
            flowfield = oflow_method(input_video[t - 2 : t + 1], device=device)
            cells_id, max_ID, newlabels, _ = tracking(
                cells_id, cell_list[-1], labels, flowfield.cpu().numpy(), max_ID,
                match_frac=match_frac, split_frac=split_frac,
                merge_frac=merge_frac, output_splits_merges=output_splits_merges,
            )
            cell_list.append(cells_id)
            label_list.append(newlabels)

    track_list = couple_track(cell_list[2:], int(max_ID), mintrack)
    return track_list, cell_list, label_list
