"""The readers of the port's spans and counters (snarkbench/spans.py and
the four metrics on it, with their `.hostbound` twins) on synthetic
requests, and in a traced run of a small cell on the CPU."""

import types

import pytest
import torch

from snarkbench import harness
from snarkbench.tests.test_snarkbench_harness import _data_dir, cpu_run

torch.set_num_threads(1)
NEW = ("ingest.copy_ms", "msm.host_ms", "host.idle_ms", "prove.syncs")
MS = 1_000_000  # ns


def _timer(spans):
    """A port timer whose records are `spans`: (name, parent index, start
    ms, end ms, host, stream idle, counts)."""
    from icicle_snark_tpu_torch import trace

    t = trace.PhaseTimer()
    for name, parent, start, end, host, idle, counts in spans:
        s = t.span(name, host)
        s.parent, s.start, s.end = parent, start * MS, end * MS
        s.stream_idle, s.counts = idle, counts
        t.records.append(s)
    return t


def _request(k):
    """One prove's spans, its times scaled by k."""
    return {"error": None, "spans": _timer([
        ("prove", None, 0, 100 * k, False, True, {}),
        ("ingest.transpose", 0, 1, 1 + 20 * k, True, True, {}),
        ("ingest.copy", 0, 30 * k, 32 * k, False, True, {"syncs": 1}),
        ("msm.g1", 0, 40 * k, 60 * k, False, False, {}),
        ("msm.accumulate", 3, 41 * k, 50 * k, False, False, {"syncs": k}),
        ("msm.combine", 0, 70 * k, 75 * k, True, True, {}),
        ("assemble.randomize", 0, 80 * k, 90 * k, True, False, {}),  # the card still busy
        ("api.write", 0, 95 * k, 96 * k, True, True, {"syncs": 0}),
    ])}


def _run(reqs):
    return types.SimpleNamespace(window_requests=reqs, data=harness.PKG)


def test_span_readers_take_medians_over_the_window():
    run = _run([_request(1), _request(3), _request(2)])
    read = harness.metric_reader
    assert read("ingest.copy_ms")(run) == pytest.approx(4.0)
    assert read("msm.host_ms")(run) == pytest.approx(10.0)
    # host spans opened on an empty stream: transpose 40, combine 10, write 2 at k = 2
    assert read("host.idle_ms")(run) == pytest.approx(40 + 10 + 2)
    assert read("prove.syncs")(run) == 1 + 2


def test_self_time_leaves_out_the_children():
    from snarkbench import spans

    req = _request(1)
    t = req["spans"]
    assert t.self_ns("msm.g1") == (20 - 9) * MS
    children = 20 + 2 + 20 + 5 + 10 + 1
    assert t.self_ns("prove") == (100 - children) * MS
    assert t.self_ns("no.such") == 0
    assert t.self_ns(spans.host_on_idle_card) == (20 + 5 + 1) * MS
    assert spans.syncs(t) == 2
    assert spans.timers(_run([{"error": None}, req])) == [t]


def test_span_readers_find_nothing_without_records():
    """The parent program's timers have phases and no records; untraced
    requests carry no timer."""
    phases_only = types.SimpleNamespace(phases={"msm": 0.05}, names=["msm"], bounds=[(0, 1)])
    for reqs in ([], [{"error": None}], [{"error": None, "spans": phases_only}]):
        for name in NEW:
            assert harness.metric_reader(name)(_run(reqs)) is None, name
            assert harness.metric_reader(f"{name}.hostbound")(_run(reqs)) is None, name


def test_hostbound_twins_read_as_their_originals():
    run = _run([_request(1), _request(2), _request(5)])
    for name in NEW:
        assert harness.metric_reader(f"{name}.hostbound")(run) == \
            harness.metric_reader(name)(run), name


def test_new_metrics_follow_the_cells_their_twins_split():
    names = {c: [m["name"] for m in harness.resolve(c)[4]]
             for c in ("complex-1600k.warm", "anon_aadhaar-1536.warm")}
    for name in NEW:
        assert name in names["complex-1600k.warm"]
        assert name not in names["anon_aadhaar-1536.warm"]
        assert f"{name}.hostbound" in names["anon_aadhaar-1536.warm"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_spans")
    data, bench = _data_dir(d)
    return data, bench, str(d / "fixtures")


def test_a_traced_run_on_the_cpu_reports_the_span_metrics(tiny):
    res = cpu_run(tiny, trace=True)
    assert res["correct"]
    for name in NEW:
        assert name in res["metrics"], name
    m = res["metrics"]
    assert 0 < m["ingest.copy_ms"]["value"] < m["ingest.ms"]["value"]
    assert 0 < m["msm.host_ms"]["value"] < m["msm.ms"]["value"]
    assert m["host.idle_ms"]["value"] > m["msm.host_ms"]["value"]
    assert m["prove.syncs"] == {"value": 0, "unit": "count"}  # no card, no waits on one


def test_the_span_checks_hold_on_the_cpu_and_catch_a_fault(tiny):
    """snarkbench/span_check.py on a traced run of the small cell on the
    CPU (no card: no sync or profiler readings), then on the same requests
    with one span moved outside its parent and one root cut short."""
    from snarkbench import span_check

    data, bench, fx = tiny
    run = harness.Run("tiny.warm", 2**40 + 11, 0.5, True, device="cpu", bench=bench, data=data,
                      fixture_root=fx, log=lambda msg: None)
    run.profile = lambda: None  # the profiled stretch is the card's
    report = span_check.check(run)
    assert report["ok"] and report["correct"], report["fails"]
    w = report["window"]
    assert w["requests"] == len(run.window_requests) > 0
    assert set(w["self_ms"]) >= {"prove", "ingest.copy", "msm.combine", "api.write"}
    assert w["syncs"] == {0: w["requests"]} and "sync_sites" not in report
    a, b = run.window_requests[0]["spans"].records, run.window_requests[-1]["spans"].records
    a[1].end = a[0].end + 1
    b[0].start += MS
    fails = span_check.window_checks(run)["fails"]
    assert fails["nesting"] == 1 and fails["root_vs_latency"] == 1
