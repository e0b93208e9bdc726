"""Host gate: wall ms a request of the port's ``pst.gate`` spans (input
checks, ``check_norain``, numpy copies and NaN fill, the inputs' copies to
the card), from the traced requests."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp or not sp["requests"] or "pst.gate" not in sp["span_s"]:
        return None
    return 1e3 * sp["span_s"]["pst.gate"] / sp["requests"]
