from pysteps_tpu_torch.feature import shitomasi  # noqa: F401
from pysteps_tpu_torch.feature.interface import get_method  # noqa: F401
