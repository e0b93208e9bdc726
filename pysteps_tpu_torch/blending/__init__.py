from pysteps_tpu_torch.blending import (  # noqa: F401
    clim,
    ens_kalman_filter_methods,
    linear_blending,
    pca_ens_kalman_filter,
    skill_scores,
    steps,
    utils,
)
from pysteps_tpu_torch.blending.interface import get_method  # noqa: F401
