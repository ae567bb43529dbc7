"""The port's one recorder: phase marks, spans and counters of a request.

`PhaseTimer` gives a prove's phase times through `mark` and `phases`; on
CUDA each mark synchronises the device first, so a phase holds its
kernels. While a call runs with it active (`activate`), it also keeps:

- spans: `span(name, host=False)` records the name, the span open at the
  time (its parent), start and end on `time.perf_counter_ns()`, the
  timer's request id, and whether the device's current stream was empty
  when the span opened (a non-blocking query; always empty on the CPU).
  `host=True` marks a span whose work runs on the host alone;
- counters, per span: `count(name, n)` adds to the innermost open span;
- blocking waits: on CUDA, every call that `torch.cuda.set_sync_debug_mode`
  flags adds one to the counter `syncs` of the innermost open span of the
  recorder active in the calling context. The mode is "warn" while any
  CUDA recorder is active in the process (the first to enter sets it and
  the last to leave restores it, under a lock, so calls on several threads
  may overlap); its warnings are counted and not shown, and the marks' own
  synchronisations are left out.

Code below the prover (`ops/`, `io/`) opens spans and counts through the
module's `span` and `count`, which act on the active recorder and do
nothing without one. A call made without a timer runs with `NULL`: no
synchronisation, no records.

The program emits no profiler ranges. Its spans share the profiler's
clock through `to_trace_ns`, which maps a span time onto the wall clock
that the profiler's records carry.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import warnings

import torch

SYNCS = "syncs"  # the counter of blocking waits
SYNC_WARNING = "called a synchronizing CUDA operation"  # torch's text for a flagged call
_NO_SPAN = contextlib.nullcontext()
_CURRENT = contextvars.ContextVar("icicle_snark_tpu_torch.trace", default=None)
_REQUESTS = itertools.count(1)


class Span:
    """One span's record. `parent` indexes the enclosing span in the
    timer's `records` (None for a root); `start` and `end` are
    `time.perf_counter_ns()`; `counts` holds the span's own counters."""

    __slots__ = ("name", "parent", "start", "end", "host", "stream_idle", "counts", "_timer")

    def __init__(self, timer: "PhaseTimer", name: str, host: bool):
        self._timer, self.name, self.host = timer, name, host
        self.parent = self.start = self.end = self.stream_idle = None
        self.counts = {}

    @property
    def duration_ns(self) -> int:
        return self.end - self.start

    def __enter__(self):
        self.start = time.perf_counter_ns()
        t = self._timer
        self.parent = t._stack[-1] if t._stack else None
        self.stream_idle = t._stream_idle()
        t._stack.append(len(t.records))
        t.records.append(self)
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        self._timer._stack.pop()
        return False


class PhaseTimer:
    """Per-phase wall times of a prove (`mark`, `phases`), and the spans
    and counters of the request it times (see the module's docstring).
    Each timer takes the next request id of the process."""

    def __init__(self, device=None):
        cuda = device is not None and torch.device(device).type == "cuda"
        self.sync = torch.cuda.synchronize if cuda else None
        self._device = device if cuda else None
        self.phases = {}
        self.request = next(_REQUESTS)
        self.records = []
        self._stack = []
        self._marking = False
        self._clock = (time.time_ns(), time.perf_counter_ns())
        self._t = time.perf_counter()

    def mark(self, name: str):
        if self.sync is not None:
            self._marking = True
            try:
                self.sync()
            finally:
                self._marking = False
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + (now - self._t)
        self._t = now

    def span(self, name: str, host: bool = False) -> Span:
        return Span(self, name, host)

    def count(self, name: str, n: int = 1):
        """Add `n` to the counter `name` of the innermost open span."""
        counts = self.records[self._stack[-1]].counts
        counts[name] = counts.get(name, 0) + n

    def self_ns(self, keep) -> int:
        """Summed over the closed spans that `keep` selects (a span name,
        or a predicate on a `Span`): each one's duration less the part its
        child spans cover."""
        if isinstance(keep, str):
            name = keep
            keep = lambda r: r.name == name  # noqa: E731
        child = [0] * len(self.records)
        for r in self.records:
            if r.parent is not None and r.end is not None:
                child[r.parent] += r.duration_ns
        return sum(r.duration_ns - child[i] for i, r in enumerate(self.records)
                   if r.end is not None and keep(r))

    def to_trace_ns(self, t: int) -> int:
        """A span time (perf_counter ns) on the wall clock (time.time_ns),
        through the pair of readings taken when the timer was built."""
        wall, perf = self._clock
        return wall + t - perf

    def _stream_idle(self) -> bool:
        return self._device is None or torch.cuda.current_stream(self._device).query()

    @contextlib.contextmanager
    def _active(self):
        token = _CURRENT.set(self)
        try:
            with self.span("prove"), _counting_syncs(self.sync is not None):
                yield self
        finally:
            _CURRENT.reset(token)


class _SyncCounting:
    """The process's state of sync counting: how many CUDA recorders are
    active, and what the first of them saved (the debug mode and the
    warning filters and hook, through one `warnings.catch_warnings`)."""

    lock = threading.Lock()
    depth = 0
    mode = None
    saved = None
    shown = None


def _show(message, category, filename, lineno, file=None, line=None):
    """The warning hook while syncs are counted: a flagged call counts
    against the recorder active in this context, if any; other warnings
    go on to the hook that was there before."""
    if not str(message).startswith(SYNC_WARNING):
        _SyncCounting.shown(message, category, filename, lineno, file, line)
        return
    timer = _CURRENT.get()
    if timer is not None and timer._stack and not timer._marking:
        timer.count(SYNCS)


@contextlib.contextmanager
def _counting_syncs(cuda: bool):
    if not cuda:
        yield
        return
    st = _SyncCounting
    with st.lock:
        if st.depth == 0:
            st.mode = torch.cuda.get_sync_debug_mode()
            st.saved = warnings.catch_warnings()
            st.saved.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            st.shown, warnings.showwarning = warnings.showwarning, _show
            torch.cuda.set_sync_debug_mode("warn")
        st.depth += 1
    try:
        yield
    finally:
        with st.lock:
            st.depth -= 1
            if st.depth == 0:
                torch.cuda.set_sync_debug_mode(st.mode)
                st.saved.__exit__(None, None, None)
                st.saved = st.shown = None


class _NullTimer:
    """The timer of a call made without one: its marks do nothing, and
    `activate` leaves no recorder active."""

    def mark(self, name: str):
        pass


NULL = _NullTimer()


def activate(timer):
    """A context in which `timer` is the active recorder, inside its root
    span `prove`; a no-op for NULL, None, or the timer already active."""
    if not isinstance(timer, PhaseTimer) or _CURRENT.get() is timer:
        return _NO_SPAN
    return timer._active()


def span(name: str, host: bool = False):
    """A span of the active recorder; a shared no-op context without one."""
    timer = _CURRENT.get()
    return _NO_SPAN if timer is None else timer.span(name, host)


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` of the active recorder's innermost
    open span; nothing without an active recorder."""
    timer = _CURRENT.get()
    if timer is not None:
        timer.count(name, n)
