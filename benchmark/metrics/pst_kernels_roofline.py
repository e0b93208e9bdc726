"""The hand-written kernels' share of their roofline, %: the sum of each
launch's least time (its bytes over the memory rate or its operations over
the float32 rate, ``harness/kernel_costs.py``) over the device time of the
``pst_*`` kernels in the traced window."""

from benchmark.harness.kernel_costs import least_seconds


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["launches"] or tr["pst_device_s"] <= 0:
        return None
    least = sum(least_seconds(e, a, ctx["device_name"])[0] for e, a in ctx["launches"])
    return 100.0 * least / tr["pst_device_s"]
