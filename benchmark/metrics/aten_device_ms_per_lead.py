"""PyTorch's own operators: device ms a lead of the kernels inside the
forecast calls that are neither cuFFT's, nor sorts, nor the port's
hand-written kernels (the elementwise work and reductions of the noise,
the AR step, the mask, the flow perturbation and the match's packing,
gathers, scatters and copies)."""

from benchmark.harness.trace import GROUPS
from benchmark.metrics import device_ms_per_lead

HAND = {group for key, group in GROUPS if key.startswith("pst_")}


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return device_ms_per_lead(ctx, set(tr["forecast_s_by_group"]) - HAND - {"fft", "sort"})
