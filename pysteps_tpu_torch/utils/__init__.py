from pysteps_tpu_torch.utils import (  # noqa: F401
    arrays,
    check_norain,
    cleansing,
    conversion,
    dimension,
    fft,
    images,
    interpolate,
    pca,
    profiling,
    spectral,
    tapering,
    transformation,
)
from pysteps_tpu_torch.utils.interface import get_method  # noqa: F401
