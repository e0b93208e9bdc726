"""Member update: device ms a lead of the cuFFT kernels inside the forecast
calls (a lead's recomposition of every member, and the init's few
single-field transforms spread over the leads)."""

from benchmark.metrics import device_ms_per_lead


def read(ctx):
    return device_ms_per_lead(ctx, ("fft",))
