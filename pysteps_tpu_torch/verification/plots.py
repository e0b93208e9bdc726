"""Verification diagnostic plots (counterpart of
``pysteps_tpu/verification/plots.py``): host matplotlib, imported inside
each function."""

import numpy as np


def plot_intensityscale(intscale, fig=None, vminmax=None, kmperpixel=None, unit=None):
    """Intensity-scale skill-score matrix plot.

    ``intscale`` is either the streaming state dict from
    ``spatialscores.intensity_scale_init`` or a raw
    (scales, thresholds) score matrix."""
    import matplotlib.pyplot as plt

    thrs = scales = None
    if isinstance(intscale, dict):
        from pysteps_tpu_torch.verification.spatialscores import intensity_scale_compute

        thrs, scales = intscale.get("thrs"), intscale.get("scales")
        intscale = intensity_scale_compute(intscale)
    intscale = np.asarray(intscale, float)
    if fig is None:
        fig = plt.figure()
    ax = fig.gca()
    im = ax.imshow(
        intscale, vmin=vminmax[0] if vminmax else None,
        vmax=vminmax[1] if vminmax else None, interpolation="nearest",
        origin="lower", aspect="auto", cmap="viridis",
    )
    fig.colorbar(im, ax=ax, label="skill")
    ax.set_xlabel("intensity threshold" + (f" [{unit}]" if unit else ""))
    ax.set_ylabel("scale" + (" [km]" if kmperpixel else " [px]"))
    if thrs is not None:
        ax.set_xticks(np.arange(intscale.shape[1]))
        ax.set_xticklabels(np.asarray(thrs))
    if scales is not None:
        scales = np.asarray(scales, float)
        if kmperpixel is not None:
            scales = scales * kmperpixel
        ax.set_yticks(np.arange(intscale.shape[0]))
        ax.set_yticklabels(scales)
    return ax


def plot_rankhist(rankhist, ax=None):
    """Rank-histogram bar plot.

    Accepts the state dict from ``ensscores.rankhist_init`` or an
    already-computed relative-frequency array."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.figure().gca()
    if isinstance(rankhist, dict):
        from pysteps_tpu_torch.verification.ensscores import rankhist_compute

        rankhist = rankhist_compute(rankhist)
    n = np.asarray(rankhist, float)
    x = np.arange(len(n))
    ax.bar(x, n, width=0.9, color="#1f77b4", edgecolor="none")
    ax.axhline(1.0 / len(n), ls="--", color="k", lw=1)
    ax.set_xlabel("rank of observation")
    ax.set_ylabel("relative frequency")
    return ax


def plot_reldiag(reldiag, ax=None):
    """Reliability-diagram plot.

    Accepts either the (obs_freq, fct_prob) tuple from reldiag_compute or a
    reldiag state dict."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.figure().gca()
    if isinstance(reldiag, dict):
        from pysteps_tpu_torch.verification.probscores import reldiag_compute

        r, f = reldiag_compute(reldiag)
    else:
        r, f = reldiag
    ax.plot([0, 1], [0, 1], "k--", lw=1)
    ax.plot(f, r, "o-", color="#1f77b4")
    ax.set_xlabel("forecast probability")
    ax.set_ylabel("observed relative frequency")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    return ax


def plot_ROC(ROC, ax=None, opt_prob_thr=False):
    """ROC-curve plot.

    Accepts the (POFD, POD[, area]) tuple from ROC_curve_compute or a ROC
    state dict."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.figure().gca()
    if isinstance(ROC, dict):
        from pysteps_tpu_torch.verification.probscores import ROC_curve_compute

        POFD, POD = ROC_curve_compute(ROC)
    else:
        POFD, POD = ROC[0], ROC[1]
    ax.plot([0, 1], [0, 1], "k--", lw=1)
    ax.plot(POFD, POD, "o-", color="#1f77b4")
    ax.set_xlabel("probability of false detection")
    ax.set_ylabel("probability of detection")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    return ax
