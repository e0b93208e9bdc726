"""Member-frames a second: every member and lead of the forecasts completed
in the window, over the window's elapsed time (host clock)."""

from benchmark.harness.stats import rate


def read(ctx):
    if not ctx["requests"] or ctx["window_s"] <= 0:
        return None
    return rate(len(ctx["requests"]) * ctx["E"] * ctx["T"], ctx["window_s"])
