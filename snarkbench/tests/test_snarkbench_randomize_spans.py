"""The reader of the randomisation's host time (metrics/assemble.host_ms.py
and its `.hostbound` twin) on synthetic requests, on a program that
randomises in one span and on one that splits it around the MSMs, and in a
traced run of a small cell on the CPU."""

import types

import pytest
import torch

from snarkbench import harness
from snarkbench.tests.test_snarkbench_harness import _data_dir, cpu_run

torch.set_num_threads(1)
NAME = "assemble.host_ms"
MS = 1_000_000  # ns


def _timer(spans):
    """A port timer whose records are `spans`: (name, parent index, start
    ms, end ms, host)."""
    from icicle_snark_tpu_torch import trace

    t = trace.PhaseTimer()
    for name, parent, start, end, host in spans:
        s = t.span(name, host)
        s.parent, s.start, s.end = parent, start * MS, end * MS
        s.stream_idle, s.counts = False, {}
        t.records.append(s)
    return t


def _split(k):
    """One prove that randomises in three spans around the MSMs, k ms each
    less a child of 1 ms in the first."""
    return {"error": None, "spans": _timer([
        ("prove", None, 0, 100, False),
        ("msm.g1", 0, 1, 10, False),
        ("assemble.precompute", 0, 10, 10 + k, True),
        ("inner", 2, 10, 11, True),
        ("msm.g2", 0, 40, 50, False),
        ("msm.combine", 0, 50, 55, True),
        ("assemble.randomize", 0, 55, 55 + k, True),
        ("assemble.randomize", 0, 80, 80 + k, True),
    ])}


def _whole(k):
    """One prove that randomises after both MSMs in one span of k ms."""
    return {"error": None, "spans": _timer([
        ("prove", None, 0, 100, False),
        ("msm.combine", 0, 50, 60, True),
        ("assemble.randomize", 0, 60, 60 + k, True),
        ("assemble.serialize", 0, 60 + k, 61 + k, True),
    ])}


def _run(reqs):
    return types.SimpleNamespace(window_requests=reqs, data=harness.PKG)


@pytest.mark.parametrize("name", [NAME, f"{NAME}.hostbound"])
def test_the_randomisation_spans_sum_their_self_time(name):
    read = harness.metric_reader(name)
    assert read(_run([_split(4), _split(10), _split(6)])) == pytest.approx(3 * 6 - 1)
    assert read(_run([_whole(30), _whole(20), _whole(25)])) == pytest.approx(25)


@pytest.mark.parametrize("name", [NAME, f"{NAME}.hostbound"])
def test_nothing_to_read_without_records(name):
    phases_only = types.SimpleNamespace(phases={"msm": 0.05}, names=["msm"], bounds=[(0, 1)])
    for reqs in ([], [{"error": None}], [{"error": None, "spans": phases_only}]):
        assert harness.metric_reader(name)(_run(reqs)) is None


def test_each_cell_reads_the_twin_of_its_end_to_end_metric():
    names = {c: [m["name"] for m in harness.resolve(c)[4]]
             for c in ("complex-1600k.warm", "anon_aadhaar-1536.warm")}
    assert NAME in names["complex-1600k.warm"]
    assert f"{NAME}.hostbound" not in names["complex-1600k.warm"]
    assert f"{NAME}.hostbound" in names["anon_aadhaar-1536.warm"]
    assert NAME not in names["anon_aadhaar-1536.warm"]


def test_a_traced_run_on_the_cpu_reports_it(tmp_path):
    data, bench = _data_dir(tmp_path)
    for m in bench["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append("tiny.warm")
    res = cpu_run((data, bench, str(tmp_path / "fixtures")), trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert 0 < m[NAME]["value"] < m["msm.ms"]["value"]
    assert m["assemble.ms"]["value"] < m[NAME]["value"]
