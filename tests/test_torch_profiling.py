"""The port's `_testpoints` and `profiling` modules on the CPU: the test
points are the JAX package's as integers; every probe entry of the
profiling report has the JAX entry's shape (the 32-bit multiplies in
place of `est_vpu_ops`) with launch counts, and the markdown report is
written. On the CPU the probes time the kernels' plain versions: the
numbers say nothing of the card."""

import json

import numpy as np
import pytest
import torch

from icicle_snark_tpu import _testpoints as jtestpoints
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu_torch import _testpoints
from icicle_snark_tpu_torch import profiling as prof
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.refmath import curve as rcv
from icicle_snark_tpu_torch.refmath.field import fq_from_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("lanes,seed", [(5, 0), (64, 3), (150, 4)])
def test_testpoints_match_jax(lanes, seed):
    got = _testpoints.random_g1_batch(lanes, seed, "cpu")
    want = jtestpoints.random_g1_batch(lanes, seed)
    for t, j in zip(got, want):
        assert t.shape == (8, lanes) and t.dtype == torch.int32
        assert lb.limbs_to_ints(t) == jlb.limbs_to_ints_np(np.asarray(j))
    x, y, _ = (lb.limbs_to_ints(t) for t in got)
    assert all(rcv.g1_is_on_curve((fq_from_mont(a), fq_from_mont(b), 1)) for a, b in zip(x, y))


def test_testpoints_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _testpoints.random_g1_batch(4)


def _check_entry(e, kernel_prefix):
    assert e["kernel"].startswith(kernel_prefix)
    assert e["time_s"] > 0
    assert e["throughput"] > 0
    assert e["sol_time_s"] > 0 and e["est_int32_muls"] > 0 and e["bytes_moved"] > 0
    assert e["bound"] in ("compute", "memory")
    assert e["device"] == "cpu" and e["launches"] == {}  # plain versions launch nothing
    json.dumps(e)


def test_mont_mul_probe():
    _check_entry(prof.profile_mont_mul(256, 1, CPU), "mont_mul")


def test_padd_probe():
    _check_entry(prof.profile_padd(64, 1, CPU), "g1_padd")


def test_ntt_probe():
    entries = prof.profile_ntt(6, 1, CPU)
    assert [e["kernel"] for e in entries] == ["ntt_2^6", "ntt_2^6_radix"]
    for e in entries:
        _check_entry(e, "ntt_2^6")


def test_msm_probe():
    _check_entry(prof.profile_msm(4, 1, CPU, c=8), "msm_g1")


def test_scaling_report_and_markdown(tmp_path):
    rows = prof.scaling_report(1, "cpu", log_n=6)
    assert [r["mesh"] for r in rows] == [1, 2, 4] and rows[0]["vs_d1"] == 1.0
    out = tmp_path / "PROFILE.md"
    prof.write_md(str(out), prof.card_name(CPU), [prof.profile_mont_mul(64, 1, CPU)], rows)
    text = out.read_text()
    assert "| mont_mul_fr |" in text and "Mesh scaling" in text


def test_bound_is_the_larger_time():
    ms, by = prof.bound(3.35e12, 0)  # a second of HBM
    assert (ms, by) == (1e3, "bytes")
    ms, by = prof.bound(0, prof.INT_MULS_PER_S)
    assert (round(ms, 9), by) == (1e3, "operations")


def test_entry_point_runs_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        prof.main([])
