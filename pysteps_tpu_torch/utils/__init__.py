from pysteps_tpu_torch.utils import check_norain, spectral, tapering  # noqa: F401
