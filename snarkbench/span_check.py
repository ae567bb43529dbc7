"""Checks of the port's spans and counters on a traced run of one cell, and
the card's idle time put on the spans:

    python3 -m snarkbench.span_check --workload <cell> --seed <n> --seconds <s> [--out FILE]

The cell runs as under `snarkbench.run --trace 1`. Every window request
that carries spans is then checked (`window_checks`):

- `nesting`: each child span lies inside its parent;
- `root_vs_latency`: the root span `prove` is within 0.5 ms of the
  request's latency;
- `copy_in_ingest`, `combine_in_msm`: the self time of `ingest.copy` is
  below the `witness_ingest` phase, that of `msm.combine` below `msm`;
- `host_idle_vs_trace`: `host.idle_ms` (the window's median) is at most
  1.05 times the profiled proves' mean idle time a prove; where the host
  runs slower in the window than in the profiled stretch after it, this
  fails without a fault in the spans;
- `host_idle_by_prove`: each profiled prove's own host idle is at most
  1.05 times its own device idle.

On a card, before the run's state is freed, also:

- `syncs_vs_flagged` (`sync_sites`): one warm prove without a timer, with
  every call `torch.cuda.set_sync_debug_mode` flags recorded by site,
  against the recorder's count for a timed prove of the same witness;
- `idle_by_span` (`profiled_gaps`, a reading, not a check): three timed
  proves under the profiler, each idle gap of the card inside the root
  put on the innermost span the host was in, through `to_trace_ns`.

A summary line goes to standard output, and the whole report to `--out`
where given. Exits 1 when a check fails, 2 without a card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

from . import harness  # noqa: E402
from . import phases as ph  # noqa: E402
from . import spans as sp  # noqa: E402

ROOT_MS = 0.5  # the root span against the request's latency
IDLE_RATIO = 1.05  # host idle against the trace's idle
SYNC_WARNING = "called a synchronizing CUDA operation"
MS = 1e6  # ns


def window_checks(run) -> dict:
    """The checks of the window requests that carry spans: the number of
    requests each check fails in, and the readings behind them."""
    timed = [r for r in run.window_requests if getattr(r.get("spans"), "records", None)]
    fails = collections.Counter({k: 0 for k in ("nesting", "root_vs_latency", "copy_in_ingest",
                                                "combine_in_msm", "host_idle_vs_trace",
                                                "host_idle_by_prove")})
    root_gap, host_idle, syncs = [], [], []
    for r in timed:
        t, recs = r["spans"], r["spans"].records
        fails["nesting"] += any(
            not (recs[s.parent].start <= s.start and s.end <= recs[s.parent].end)
            for s in recs if s.parent is not None)
        root_gap.append(r["latency"] * 1e3 - recs[0].duration_ns / MS)
        fails["root_vs_latency"] += abs(root_gap[-1]) > ROOT_MS
        fails["copy_in_ingest"] += not t.self_ns("ingest.copy") / MS < \
            r["phases"]["witness_ingest"] * 1e3
        fails["combine_in_msm"] += not t.self_ns("msm.combine") / MS < r["phases"]["msm"] * 1e3
        host_idle.append(t.self_ns(sp.host_on_idle_card) / MS)
        syncs.append(sp.syncs(t))
    profiled = [(p["span"] - p["busy_total"]) * 1e3 for p in run.profiled]
    own = [p["req"]["spans"].self_ns(sp.host_on_idle_card) / MS for p in run.profiled
           if getattr(p["req"]["spans"], "records", None)]
    trace_idle = statistics.fmean(profiled) if profiled else None
    if trace_idle is not None and host_idle:
        fails["host_idle_vs_trace"] += statistics.median(host_idle) > IDLE_RATIO * trace_idle
    fails["host_idle_by_prove"] += sum(h > IDLE_RATIO * d for h, d in zip(own, profiled))
    return {"requests": len(timed), "fails": dict(fails),
            "root_gap_ms": [min(root_gap), max(root_gap)] if root_gap else None,
            "host_idle_ms": statistics.quantiles(host_idle, n=4) if len(host_idle) > 1
            else host_idle,
            "trace_idle_ms_per_prove": trace_idle,
            "profiled": [{"idle_ms": d, "host_idle_ms": h} for h, d in zip(own, profiled)],
            "syncs": dict(sorted(collections.Counter(syncs).items())),
            "self_ms": {name: statistics.median(t.self_ns(name) / MS for t in sp.timers(run))
                        for name in dict.fromkeys(s.name for t in sp.timers(run)
                                                  for s in t.records)}}


def sync_sites(run, w: int = 0) -> dict:
    """One warm prove of witness `w` without a timer, every flagged call
    recorded by site, and the recorder's count for a timed prove of it."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            req = run.prover.call(w)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if req["error"]:
        raise RuntimeError(req["error"])
    root = os.getcwd()
    sites = collections.Counter(f"{os.path.relpath(x.filename, root)}:{x.lineno}"
                                for x in got if str(x.message).startswith(SYNC_WARNING))
    timed = run.prover.call(w, timer_factory=lambda i: ph.timer_class()(run.device, "syncs"))
    by_span = collections.Counter()
    for s in timed["spans"].records:
        by_span[s.name] += s.counts.get(sp.SYNCS, 0)
    return {"flagged": sum(sites.values()), "sites": dict(sites),
            "counted": sp.syncs(timed["spans"]), "by_span": {k: v for k, v in by_span.items() if v}}


def _innermost(recs) -> list:
    """[(start, end, name)] cutting the root at every span bound, each
    piece named after the innermost span open over it."""
    cuts = sorted({r.start for r in recs} | {r.end for r in recs})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        inner = [r for r in recs if r.start <= a and b <= r.end]
        if inner:
            out.append((a, b, max(inner, key=lambda r: r.start).name))
    return out


def profiled_gaps(run, n: int = 3, w: int = 0) -> list:
    """n timed proves of witness `w` under the profiler, one warm-up step
    first: a prove's device busy and idle time inside its root span, the
    idle put on the innermost span the host was in, and the host's idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    spans = ph.timer_class()
    done = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
        for k in range(n + 1):
            done.append(run.prover.call(w, timer_factory=lambda i, k=k: spans(run.device, f"g{k}")))
            prof.step()
    device = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    out = []
    for req in done[1:]:
        t = req["spans"]
        lo, hi = t.to_trace_ns(t.records[0].start), t.to_trace_ns(t.records[0].end)
        busy = ph.merge([(max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi])
        idle = collections.Counter()
        for a, b, name in _innermost(t.records):
            a, b = t.to_trace_ns(a), t.to_trace_ns(b)
            idle[name] += b - a - sum(max(0, min(b, y) - max(a, x)) for x, y in busy)
        out.append({"root_ms": (hi - lo) / MS, "busy_ms": sum(b - a for a, b in busy) / MS,
                    "idle_ms": sum(idle.values()) / MS,
                    "host_idle_ms": t.self_ns(sp.host_on_idle_card) / MS,
                    "idle_by_span_ms": {k: v / MS for k, v in idle.most_common()}})
    return out


def check(run) -> dict:
    """Run the cell traced, with the card's checks before its state is
    freed; the report, with `ok` false where a check failed."""
    import torch

    report = {}
    count_work = run.count_work
    if torch.device(run.device).type == "cuda":
        def on_card():
            report["sync_sites"] = sync_sites(run)
            report["idle_by_span"] = profiled_gaps(run)
            count_work()

        run.count_work = on_card
    result = harness.execute(run)
    report["window"] = window_checks(run)
    fails = dict(report["window"]["fails"])
    if "sync_sites" in report:
        s = report["sync_sites"]
        fails["syncs_vs_flagged"] = int(s["flagged"] != s["counted"])
    report.update(ok=result["correct"] and not any(fails.values()), fails=fails,
                  correct=result["correct"], card=harness.card_power(),
                  metrics={k: v["value"] for k, v in result["metrics"].items()})
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m snarkbench.span_check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[span_check] needs a CUDA card", file=sys.stderr)
        return 2
    run = harness.Run(args.workload, args.seed, args.seconds, True, t_start=T_START)
    report = check(run)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    w = report["window"]
    print(json.dumps({"workload": args.workload, "ok": report["ok"], "fails": report["fails"],
                      "requests": w["requests"], "root_gap_ms": w["root_gap_ms"],
                      "host_idle_ms": w["host_idle_ms"],
                      "trace_idle_ms_per_prove": w["trace_idle_ms_per_prove"],
                      "syncs": w["syncs"], "sync_sites": report.get("sync_sites"),
                      "card": report["card"]}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
