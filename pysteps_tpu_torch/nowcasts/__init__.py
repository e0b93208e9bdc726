from pysteps_tpu_torch.nowcasts import (  # noqa: F401
    anvil,
    extrapolation,
    lagrangian_probability,
    linda,
    sprog,
    sseps,
    steps,
    utils,
)
from pysteps_tpu_torch.nowcasts.interface import get_method  # noqa: F401
