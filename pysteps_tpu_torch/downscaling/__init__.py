from pysteps_tpu_torch.downscaling import rainfarm  # noqa: F401
from pysteps_tpu_torch.downscaling.interface import get_method  # noqa: F401
