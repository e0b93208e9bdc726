"""Init: device idle ms a request while the host is inside the port's
``pst.init`` span: the span's interval less the union of kernel and copy
intervals (busy as ``device_idle_pct`` counts it), from the traced
requests."""

from benchmark.harness.spans import per_request


def read(ctx):
    v = per_request(ctx, "idle_s", "pst.init")
    return None if v is None else 1e3 * v
