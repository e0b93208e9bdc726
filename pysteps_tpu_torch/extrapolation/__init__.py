from pysteps_tpu_torch.extrapolation import semilagrangian  # noqa: F401
from pysteps_tpu_torch.extrapolation.interface import get_method  # noqa: F401
