"""The checks that decide `correct`, shown to fail: a whole run of a small
cell on the CPU, skipping only the look for a card, with each fault the
cell can have planted under the timed path (faults.py). The cell runs on
one card, so there is no exchange between cards to leave out."""

import pytest
import torch

from snarkbench import faults, harness
from snarkbench.tests.test_snarkbench_harness import cpu_run, tiny  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("mode, number", [
    ("unchanged", "repeated"),    # a step that returns its state unchanged
    ("half", "wrong"),            # half of the batch left out
    ("public", "wrong"),          # an answer altered where it is produced
    ("point", "wrong"),
    ("once", "wrong"),            # one wrong answer among many
    ("truncated", "wrong"),       # the control: h at 240 bits
    ("deterministic", "repeated"),  # the control: the program's own r = s = 1 path
])
def test_a_planted_fault_makes_the_run_incorrect(tiny, mode, number):  # noqa: F811
    with faults.planted(mode):
        res = cpu_run(tiny, seed=2**40 + 11, seconds=7.0)
    assert res["attempted"] >= 2
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_one_wrong_answer_among_many_batches_is_counted(tiny, monkeypatch):  # noqa: F811
    monkeypatch.setattr(harness, "PAIRING_BATCH", 1)
    with faults.planted("once"):
        res = cpu_run(tiny, seed=2**40 + 13, seconds=7.0)
    assert res["attempted"] >= 3
    assert res["checks"]["wrong"]["value"] == 1 and not res["correct"]


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        with faults.planted("nonsense"):
            pass
