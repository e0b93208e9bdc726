"""The 90th percentile of the latency of every request of the window, from
its host inputs handed over to its output ready on the card (host clock,
after a synchronize)."""

from benchmark.harness.stats import percentile


def read(ctx):
    lat = [r["latency_s"] for r in ctx["requests"]]
    return percentile(lat, 90) if lat else None
