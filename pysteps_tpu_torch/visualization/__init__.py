from pysteps_tpu_torch.visualization import (  # noqa: F401
    animations,
    basemaps,
    motionfields,
    precipfields,
    spectral,
    thunderstorms,
    utils,
)
from pysteps_tpu_torch.visualization.animations import animate  # noqa: F401
from pysteps_tpu_torch.visualization.motionfields import (  # noqa: F401
    motion_plot,
    quiver,
    streamplot,
)
from pysteps_tpu_torch.visualization.precipfields import plot_precip_field  # noqa: F401
from pysteps_tpu_torch.visualization.spectral import plot_spectrum1d  # noqa: F401
