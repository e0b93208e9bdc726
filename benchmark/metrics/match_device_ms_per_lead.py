"""Probability matching: device ms a request and a lead of the kernels and
copies launched inside the port's ``pst.match`` spans (the CDF match with
its packing and its sorts), attributed by launch (``harness/spans.py``),
from the traced requests."""

from benchmark.harness.spans import per_request


def read(ctx):
    v = per_request(ctx, "device_s", "pst.match", leads=True)
    return None if v is None else 1e3 * v
