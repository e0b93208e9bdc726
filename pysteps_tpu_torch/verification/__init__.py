from pysteps_tpu_torch.verification import (  # noqa: F401
    detcatscores,
    detcontscores,
    ensscores,
    probscores,
    spatialscores,
)
from pysteps_tpu_torch.verification.interface import get_method  # noqa: F401
from pysteps_tpu_torch.verification.probscores import CRPS  # noqa: F401
