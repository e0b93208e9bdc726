"""
Fit the BPS2006 a*t^b+c motion-perturbation growth curves to the output of
run_vel_pert_analysis (reference: pysteps/scripts/fit_vel_pert_params.py).
"""

import argparse
import pickle

import numpy as np


def growth_curve(t, a, b, c):
    """BPS2006 lead-time growth model sigma(t) = a * t^b + c."""
    return a * np.power(t, b) + c


def compute_stds(results):
    """Per-lead-time parallel/perpendicular standard deviations from the
    accumulated moment sums (reference: fit_vel_pert_params.py:33-56)."""
    leadtimes = sorted(results)
    std_par, std_perp = [], []
    for lt in leadtimes:
        r = results[lt]
        n = r["n_samples"]
        for sums, out in (
            ((r["dp_par_sum"], r["dp_par_sq_sum"]), std_par),
            ((r["dp_perp_sum"], r["dp_perp_sq_sum"]), std_perp),
        ):
            s, sq = sums
            mu = s / n
            out.append(np.sqrt((sq - 2 * mu * s + n * mu**2) / n))
    return np.asarray(leadtimes, float), np.asarray(std_par), np.asarray(std_perp)


def fit_parameters(results):
    """Fit (a, b, c) for the parallel and perpendicular components.
    Returns (p_par, p_perp) or (None, None) when the fit diverges."""
    from scipy.optimize import curve_fit

    leadtimes, std_par, std_perp = compute_stds(results)
    p0 = (1.0, 0.5, 0.0)
    try:
        p_par = curve_fit(growth_curve, leadtimes, std_par, p0=p0,
                          maxfev=10000)[0]
        p_perp = curve_fit(growth_curve, leadtimes, std_perp, p0=p0,
                           maxfev=10000)[0]
        return p_par, p_perp
    except RuntimeError:
        return None, None


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Fit STEPS motion perturbation parameters to the "
        "results of run_vel_pert_analysis and optionally plot them."
    )
    parser.add_argument("inputfile", help="analysis results pickle")
    parser.add_argument("--plot", metavar="filename",
                        help="save a fit plot to <filename>")
    args = parser.parse_args(argv)

    with open(args.inputfile, "rb") as f:
        results = pickle.load(f)

    leadtimes, std_par, std_perp = compute_stds(results)
    p_par, p_perp = fit_parameters(results)
    if p_par is not None:
        print(f"p_par  = {p_par}")
        print(f"p_perp = {p_perp}")
    else:
        print("Parameter fitting failed.")

    if args.plot is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        plt.scatter(leadtimes, std_par, c="r", label="parallel")
        plt.scatter(leadtimes, std_perp, c="g", label="perpendicular")
        if p_par is not None:
            t = np.linspace(0.5 * leadtimes[0], 1.025 * leadtimes[-1], 200)
            plt.plot(t, growth_curve(t, *p_par), "r-")
            plt.plot(t, growth_curve(t, *p_perp), "g-")
        plt.xlabel("Lead time (minutes)")
        plt.ylabel("Standard deviation of differences (km/h)")
        plt.legend()
        plt.grid(True)
        plt.savefig(args.plot, bbox_inches="tight")


if __name__ == "__main__":
    main()
