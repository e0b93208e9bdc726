"""Advection: device ms a request and a lead of the kernels and copies
launched inside the port's ``pst.warp`` spans (the displacement's
integration and K1's warps), attributed by launch (``harness/spans.py``),
from the traced requests."""

from benchmark.harness.spans import per_request


def read(ctx):
    v = per_request(ctx, "device_s", "pst.warp", leads=True)
    return None if v is None else 1e3 * v
