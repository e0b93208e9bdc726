from pysteps_tpu_torch.tracking import lucaskanade  # noqa: F401
from pysteps_tpu_torch.tracking.interface import get_method  # noqa: F401
