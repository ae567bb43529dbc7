"""The card's part of a run, at a small size: a traced run of a small cell
on CUDA, the profiled stretch and its reading included. Skips without a
card; on the card: `python -m pytest snarkbench/tests -q -m chip`."""

import pytest
import torch

from snarkbench import harness
from snarkbench.tests.test_snarkbench_harness import _data_dir


@pytest.mark.chip
def test_a_traced_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data, bench = _data_dir(tmp_path)
    run = harness.Run("tiny.warm", 2**40 + 21, 2.0, True, device="cuda", bench=bench,
                      data=data, fixture_root=str(tmp_path / "fixtures"), log=print)
    res = harness.execute(run)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for name in ("msm.ms", "msm_roofline", "device.idle_pct"):
        assert name in res["metrics"], name
    assert 0 < res["metrics"]["msm_roofline"]["value"] <= 100
    assert res["breakdown"]["device_ops"]


@pytest.mark.chip
def test_the_window_trace_gives_device_time_per_proof(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data, bench = _data_dir(tmp_path)
    for m in bench["end_to_end"]:
        if m["name"] == "device_ms_per_proof":
            m["workloads"].append("tiny.warm")
    run = harness.Run("tiny.warm", 2**40 + 23, 2.0, False, device="cuda", bench=bench,
                      data=data, fixture_root=str(tmp_path / "fixtures"), log=print)
    res = harness.execute(run)
    assert res["correct"], res["checks"]
    value = res["metrics"]["device_ms_per_proof"]["value"]
    latencies = sorted(r["latency"] for r in run.window_requests)
    assert 0 < value < latencies[len(latencies) // 2] * 1e3
