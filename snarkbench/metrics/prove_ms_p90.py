"""The 90th percentile (nearest rank) of every window request's latency,
call to return with both files written, in ms. A failed request counts as
infinitely slow."""

import math


def read(run):
    from snarkbench.harness import percentile

    lat = [math.inf if r["error"] else r["latency"] for r in run.window_requests]
    return percentile(lat, 90) * 1e3 if lat else None
