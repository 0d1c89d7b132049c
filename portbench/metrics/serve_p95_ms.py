"""serve_p95_ms: the 95th percentile of every request's time in the
window, from the call to the labels on the host (host clock)."""

import statistics


def read(ctx):
    if len(ctx.latencies_s) < 20:
        return None
    return statistics.quantiles(ctx.latencies_s, n=20)[-1] * 1e3
