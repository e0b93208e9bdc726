from pysteps_tpu_torch.nowcasts import steps, utils  # noqa: F401
from pysteps_tpu_torch.nowcasts.interface import get_method  # noqa: F401
