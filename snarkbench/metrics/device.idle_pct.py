"""Share of the profiled proves' wall time in which no operation ran on
the card: 100 (1 - busy / span), from the profiler's device records."""


def read(run):
    span = sum(p["span"] for p in run.profiled)
    if not run.profiled or span <= 0:
        return None
    return 100.0 * (1.0 - sum(p["busy_total"] for p in run.profiled) / span)
