"""The checks of the port's spans (snarkbench/span_check.py) on a traced run
of a small cell on CUDA: nesting, the root against the latency, the copy
and the combine inside their phases, host idle against the trace's idle,
and the recorder's blocking waits against those torch flags. Skips
without a card; on the card: `python -m pytest snarkbench/tests -q -m chip`.
A full cell: `python3 -m snarkbench.span_check --workload <cell> ...`."""

import pytest
import torch

from snarkbench import harness, span_check
from snarkbench.tests.test_snarkbench_harness import _data_dir


@pytest.mark.chip
def test_the_span_checks_hold_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data, bench = _data_dir(tmp_path)
    run = harness.Run("tiny.warm", 2**40 + 29, 2.0, True, device="cuda", bench=bench,
                      data=data, fixture_root=str(tmp_path / "fixtures"), log=print)
    report = span_check.check(run)
    assert report["ok"], report["fails"]
    s = report["sync_sites"]
    assert s["flagged"] == s["counted"] > 0 and s["by_span"]
    assert report["window"]["profiled"] and report["idle_by_span"]
    for prove in report["idle_by_span"]:
        assert 0 <= prove["host_idle_ms"] <= prove["idle_ms"] * span_check.IDLE_RATIO
