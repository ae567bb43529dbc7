"""One reader a metric, named as in BENCHMARK.json: `read(run)` takes the
run's requests, phases, cache load, profiled proves and work count
(harness.Run) and returns the number, or None where it finds nothing to
read (the harness then leaves the metric out of the line)."""


def phase_median_ms(run, *phases):
    """Median over the traced run's window proves of the sum of the named
    PhaseTimer phases, ms; None without phases."""
    import statistics

    vals = [sum(r["phases"][p] for p in phases)
            for r in run.window_requests if r.get("phases")]
    return statistics.median(vals) * 1e3 if vals else None
