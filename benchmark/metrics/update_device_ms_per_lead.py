"""Member update: device ms a request and a lead of the kernels and copies
launched inside the port's ``pst.update`` spans (noise draw and filter,
level split, AR step, recompose; in blending also the blend weights and
the composite), attributed by launch (``harness/spans.py``), from the
traced requests."""

from benchmark.harness.spans import per_request


def read(ctx):
    v = per_request(ctx, "device_s", "pst.update", leads=True)
    return None if v is None else 1e3 * v
