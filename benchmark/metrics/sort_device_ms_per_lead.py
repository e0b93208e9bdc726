"""Probability matching: device ms a lead of the sort kernels inside the
forecast calls (the CDF match's two packed sorts a lead, the target's sort
once a forecast)."""

from benchmark.metrics import device_ms_per_lead


def read(ctx):
    return device_ms_per_lead(ctx, ("sort",))
