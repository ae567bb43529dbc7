"""Phase spans of a prove and their reading against the device trace.

`PhaseSpans` is the port's `PhaseTimer` (prover/pipeline.py), passed to
`groth16_prove(..., timer=)`: each mark synchronises the device, then
closes one `torch.profiler.record_function` range and opens the next, so
the host's phases lie as ranges in the trace and every device operation
runs inside the range of the phase that launched it. The range after the
last mark (the JSON writes) is closed by `close` and named "api".

`attribute` reads plain tuples, so the reading is testable without a
profiler: device intervals are clipped to each phase range, merged where
they overlap, and summed; the idle gaps between them are labelled with the
phase the host was in.
"""

from __future__ import annotations

import time

SPAN_PREFIX = "snarkbench.span."
TAIL = "api"


def timer_class():
    """PhaseSpans, built on the port's PhaseTimer at first use (the port
    is imported after the benchmark has checked for a card)."""
    import torch
    from icicle_snark_tpu_torch.prover.pipeline import PhaseTimer

    class PhaseSpans(PhaseTimer):
        """A PhaseTimer whose phases are also profiler ranges; `names` and
        `bounds` keep each range's phase name and host interval."""

        def __init__(self, device, tag: str):
            self.tag, self.names, self.bounds = tag, [], []
            self._open()
            super().__init__(device)  # the first phase starts after the range opens

        def _open(self):
            self._range = torch.profiler.record_function(
                f"{SPAN_PREFIX}{self.tag}.{len(self.names)}")
            self._range.__enter__()
            self._t0 = time.perf_counter()

        def _shut(self, name):
            self._range.__exit__(None, None, None)
            self.names.append(name)
            self.bounds.append((self._t0, time.perf_counter()))

        def mark(self, name: str):
            super().mark(name)
            self._shut(name)
            self._open()

        def close(self):
            if self.sync is not None:
                self.sync()
            self._shut(TAIL)

    return PhaseSpans


def merge(intervals: list) -> list:
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def attribute(phases: list, device: list) -> dict:
    """phases: [(name, start, end)] in time order, one prove's ranges;
    device: [(op name, start, end)] device operations, same clock.
    Returns busy time per phase, the total busy time and the wall span
    (first phase start to last phase end), the device time by op name,
    and the idle gaps [(phase, length)] inside the span."""
    if not phases:
        return {"busy": {}, "busy_total": 0.0, "span": 0.0, "ops": {}, "gaps": []}
    lo, hi = phases[0][1], phases[-1][2]
    busy, ops, gaps = {}, {}, []
    for name, s, e in phases:
        clipped = [(max(ds, s), min(de, e)) for _, ds, de in device if de > s and ds < e]
        union = merge(clipped)
        busy[name] = busy.get(name, 0.0) + sum(b - a for a, b in union)
        cursor = s
        for a, b in union:
            if a > cursor:
                gaps.append((name, a - cursor))
            cursor = max(cursor, b)
        if e > cursor:
            gaps.append((name, e - cursor))
    for name, ds, de in device:
        if de > lo and ds < hi:
            ops[name] = ops.get(name, 0.0) + min(de, hi) - max(ds, lo)
    return {"busy": busy, "busy_total": sum(busy.values()), "span": hi - lo, "ops": ops,
            "gaps": gaps}


def kernel_name(op: str) -> str:
    """'void msm_accumulate_kernel<E2, true>(int, ...)' -> 'msm_accumulate_kernel<E2, true>'."""
    return op.split("(")[0].removeprefix("void ").strip()
