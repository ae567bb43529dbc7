"""Median of each request's latency less its PhaseTimer phases: the API
layer's cache lookup and JSON writes, ms."""

import statistics


def read(run):
    vals = [r["latency"] - sum(r["phases"].values())
            for r in run.window_requests if r.get("phases")]
    return statistics.median(vals) * 1e3 if vals else None
