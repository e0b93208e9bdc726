"""
Motion-field uncertainty analysis vs lead time (BPS2006)
(reference: pysteps/scripts/run_vel_pert_analysis.py).

Estimates how much optical-flow motion fields decorrelate with lead time by
projecting future-minus-initial flow differences onto the initial flow's
parallel/perpendicular axes and accumulating their first two moments per
lead time.  The output feeds fit_vel_pert_params.

Unlike the reference (module-level script code), the analysis is an
importable function; `main()` provides the same CLI.  The optical flow runs
on the card unless ``device="cpu"`` is passed (``--device cpu``); each
motion field is read back to the host once.
"""

import argparse
import pickle
from datetime import datetime, timedelta

import numpy as np

from pysteps_tpu_torch._device import to_numpy


def accumulate_pair(results, velocity_initial, velocity_future, leadtime,
                    use_precip_mask=False):
    """Project the flow difference onto the initial flow's parallel and
    perpendicular axes and accumulate moment sums for `leadtime`
    (reference: run_vel_pert_analysis.py:130-176)."""
    V1 = np.asarray(velocity_initial, float)
    V2 = np.asarray(velocity_future, float)
    N = np.linalg.norm(V1, axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        V1_par = V1 / N
    V1_perp = np.stack([-V1_par[1], V1_par[0]])

    DV = V2 - V1
    DP_par = DV[0] * V1_par[0] + DV[1] * V1_par[1]
    DP_perp = DV[0] * V1_perp[0] + DV[1] * V1_perp[1]

    if use_precip_mask:
        mask = np.isfinite(V1[0]) & np.isfinite(V2[0]) & np.isfinite(DP_par)
    else:
        mask = np.isfinite(DP_par)
    DP_par = DP_par[mask]
    DP_perp = DP_perp[mask]

    entry = results.setdefault(
        leadtime,
        {"dp_par_sum": 0.0, "dp_par_sq_sum": 0.0, "dp_perp_sum": 0.0,
         "dp_perp_sq_sum": 0.0, "n_samples": 0},
    )
    entry["dp_par_sum"] += float(np.sum(DP_par))
    entry["dp_par_sq_sum"] += float(np.sum(DP_par**2))
    entry["dp_perp_sum"] += float(np.sum(DP_perp))
    entry["dp_perp_sq_sum"] += float(np.sum(DP_perp**2))
    entry["n_samples"] += int(DP_par.size)
    return results


def run_analysis(startdate, enddate, datasource, oflow_method, maxleadtime,
                 num_prev_files=9, use_precip_mask=False, results=None, device=None):
    """Compute motion fields over an archive period and accumulate
    lead-time-binned perturbation statistics
    (reference: run_vel_pert_analysis.py:57-176)."""
    from pysteps_tpu_torch import io, motion
    from pysteps_tpu_torch.utils import transformation

    importer = io.get_method(datasource["importer"], "importer")
    oflow = motion.get_method(oflow_method)
    results = results if results is not None else {}

    motionfields = {}
    curdate = startdate
    while curdate <= enddate:
        try:
            fns = io.archive.find_by_date(
                curdate, datasource["root_path"], datasource["path_fmt"],
                datasource["fn_pattern"], datasource["fn_ext"],
                datasource["timestep"], num_prev_files=num_prev_files,
            )
        except IOError:
            curdate += timedelta(minutes=datasource["timestep"])
            continue
        if any(fn is None for fn in fns[0]):
            curdate += timedelta(minutes=datasource["timestep"])
            continue

        R, _, metadata = io.readers.read_timeseries(
            fns, importer, **datasource.get("importer_kwargs", {})
        )
        if any(not np.any(np.isfinite(R[i])) for i in range(R.shape[0])):
            curdate += timedelta(minutes=datasource["timestep"])
            continue

        # flow in km/h: pixels/timestep * (60/timestep) * km/pixel
        vsf = 60.0 / datasource["timestep"] * metadata["xpixelsize"] / 1000.0
        R = np.where(np.isfinite(R), R, metadata["zerovalue"])
        R = transformation.dB_transform(R, device=device)[0]
        R_in = R[-2:] if oflow_method == "vet" else R
        V = to_numpy(oflow(R_in, device=device)) * vsf
        # discard diverged retrievals
        if np.nanmean(np.linalg.norm(V, axis=0)) > 0.5 * R.shape[1]:
            curdate += timedelta(minutes=datasource["timestep"])
            continue
        motionfields[curdate] = V.astype(np.float32)
        curdate += timedelta(minutes=datasource["timestep"])

    dates = sorted(motionfields)
    for i, date1 in enumerate(dates):
        if date1 + timedelta(minutes=maxleadtime) > enddate:
            continue
        for date2 in dates[i + 1:]:
            lt = (date2 - date1).total_seconds() / 60
            if lt > maxleadtime:
                continue
            accumulate_pair(
                results, motionfields[date1], motionfields[date2], lt,
                use_precip_mask=use_precip_mask,
            )
    return results


def main(argv=None):
    from pysteps_tpu_torch import config

    parser = argparse.ArgumentParser(
        description="Estimate motion perturbation parameters for STEPS."
    )
    parser.add_argument("startdate", help="start date (YYYYmmDDHHMM)")
    parser.add_argument("enddate", help="end date (YYYYmmDDHHMM)")
    parser.add_argument("datasource", help="data source to use")
    parser.add_argument("oflow", help="optical flow method (darts|lk|vet)")
    parser.add_argument("maxleadtime", type=int, help="max lead time (min)")
    parser.add_argument("outfile", help="output pickle file")
    parser.add_argument("--accum", metavar="filename",
                        help="accumulate onto a previous results file")
    parser.add_argument("--device", default=None,
                        help="device of the optical flow (default: cuda)")
    args = parser.parse_args(argv)

    results = None
    if args.accum is not None:
        with open(args.accum, "rb") as f:
            results = pickle.load(f)

    results = run_analysis(
        datetime.strptime(args.startdate, "%Y%m%d%H%M"),
        datetime.strptime(args.enddate, "%Y%m%d%H%M"),
        config.rcparams["data_sources"][args.datasource],
        args.oflow,
        args.maxleadtime,
        results=results,
        device=args.device,
    )
    with open(args.outfile, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main()
