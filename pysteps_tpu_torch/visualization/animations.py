"""
Forecast animation (reference: pysteps/visualization/animations.py:24).
"""

import matplotlib.pyplot as plt

from pysteps_tpu_torch._device import to_numpy
from pysteps_tpu_torch.visualization.precipfields import plot_precip_field
from pysteps_tpu_torch.visualization.motionfields import quiver

PRECIP_VALID_TYPES = ("ensemble", "mean", "prob")
MOTION_VALID_METHODS = ("quiver", "streamplot")


def animate(
    precip_obs,
    precip_fct=None,
    timestamps_obs=None,
    timestep_min=5,
    motion_field=None,
    ptype="ensemble",
    motion_plot="quiver",
    geodata=None,
    title=None,
    prob_thr=None,
    display_animation=True,
    nloops=1,
    time_wait=0.2,
    savefig=False,
    fig_dpi=100,
    fig_format="png",
    path_outputs="",
    precip_kwargs=None,
    motion_kwargs=None,
    map_kwargs=None,
):
    """Animate observations and forecasts frame by frame
    (reference: animations.py:24).  With savefig=True, writes one image
    per frame to path_outputs.  The fields may be numpy or torch tensors on
    any device; each is read back to the host once."""
    precip_obs = to_numpy(precip_obs)
    precip_kwargs = precip_kwargs or {}
    if motion_field is not None:
        motion_field = to_numpy(motion_field)  # once, not once a frame
    n_obs = precip_obs.shape[0]
    frames = [("obs", i, precip_obs[i]) for i in range(n_obs)]
    if precip_fct is not None:
        precip_fct = to_numpy(precip_fct)
        fct = precip_fct.mean(axis=0) if precip_fct.ndim == 4 else precip_fct
        frames += [("fct", i, fct[i]) for i in range(fct.shape[0])]

    for loop in range(nloops if display_animation else 1):
        for kind, i, frame in frames:
            fig = plt.figure(dpi=fig_dpi)
            ax = plot_precip_field(frame, geodata=geodata, **precip_kwargs)
            if motion_field is not None and motion_plot == "quiver":
                quiver(motion_field, ax=ax)
            label = f"{kind} +{i * timestep_min} min"
            ax.set_title(title or label)
            if savefig:
                fig.savefig(
                    f"{path_outputs}/frame_{kind}_{i:03d}.{fig_format}",
                    dpi=fig_dpi, bbox_inches="tight",
                )
            if display_animation:
                plt.pause(time_wait)
            plt.close(fig)
