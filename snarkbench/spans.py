"""Readings of the port's spans and counters (icicle_snark_tpu_torch/trace.py)
in a traced run's window requests.

Each request's timer (`r["spans"]`) keeps `records`, one a span: its name,
`parent` (the index of the enclosing span, None for the root), `start` and
`end` in ns on the host clock, `host` (the span's work runs on the host
alone), `stream_idle` (the card's stream was empty when it opened) and
`counts` (its own counters); `self_ns(keep)` sums the self time of the
spans a name or predicate selects. A timer without records, as a program
without spans has, gives nothing: a reader then finds nothing to read (None).
"""

from __future__ import annotations

import statistics

SYNCS = "syncs"  # the port's counter of blocking waits


def timers(run) -> list:
    """The timers of the window requests that keep spans."""
    return [t for t in (r.get("spans") for r in run.window_requests)
            if getattr(t, "records", None)]


def host_on_idle_card(span) -> bool:
    """A host-only span that opened with the card's stream empty: its self
    time is card idle that the host's own work accounts for."""
    return bool(span.host and span.stream_idle)


def syncs(timer) -> int:
    """A request's blocking waits: the counter `syncs` over every span."""
    return sum(r.counts.get(SYNCS, 0) for r in timer.records)


def median(run, reading, scale: float | None = None):
    """Median over the window requests of `reading(timer)`, times `scale`
    where given; None where no request keeps spans."""
    vals = [reading(t) for t in timers(run)]
    if not vals:
        return None
    return statistics.median(vals) if scale is None else statistics.median(vals) * scale


def self_ms(run, keep):
    """Median self time a request of the spans `keep` selects, ms."""
    return median(run, lambda t: t.self_ns(keep), 1e-6)
