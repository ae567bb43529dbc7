"""The benchmark's MSM work count and bound."""

import numpy as np
import pytest

from snarkbench import roofline as rl
from snarkbench.reference.field import R_MOD


def test_nonzero_digits_of_known_scalars():
    w = rl.as_words([0, 1, 0xFF, 0x100, 2**64 + 1, 2**70])
    # c = 8: 1 -> d0; 0xff -> d0; 0x100 -> d1; 2^64 + 1 -> d0, d8; 2^70 -> d8
    assert rl.digit_counts(w, 8) == [3, 1, 0, 0, 0, 0, 0, 0, 2]
    # c = 5 across a word boundary: 2^64 sits in digit 12 (bits 60-64)
    assert rl.digit_counts(rl.as_words([2**64]), 5) == [0] * 12 + [1]
    assert rl.digit_counts(rl.as_words([0, 0]), 4) == []
    assert rl.digit_counts(rl.as_words([2**64 - 1]), 16) == [1, 1, 1, 1]


def test_digit_counts_match_a_python_count():
    rng = np.random.default_rng(3)
    vals = [int(rng.integers(0, 2**63)) << int(rng.integers(0, 190)) for _ in range(300)]
    vals = [v % R_MOD for v in vals]
    for c in (1, 3, 7, 13, 16, 22):
        top = max(vals).bit_length()
        want = [sum(1 for v in vals if (v >> lo) & ((1 << c) - 1)) for lo in range(0, top, c)]
        while want and not want[-1]:
            want.pop()
        assert rl.digit_counts(rl.as_words(vals), c) == want


def test_uniform_counts_sum_to_the_expectation():
    for c in (8, 16):
        counts = rl.uniform_digit_counts(1000, c)
        assert len(counts) == -(-254 // c)
        assert all(k <= 1000 for k in counts)
        assert counts[0] == pytest.approx(1000 * (1 - 2 ** -c), rel=1e-9)


def test_best_window_follows_the_scalars():
    rng = np.random.default_rng(5)
    uniform = rl.as_words([int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(1 << 14)])
    bits = rl.as_words([int(b) for b in rng.integers(0, 2, 1 << 14)])
    cu = rl.best_msm(rl.Scalars(uniform).digit_counts, "g1")["c"]
    cb = rl.best_msm(rl.Scalars(bits).digit_counts, "g1")["c"]
    assert cb == 1 and 8 <= cu <= 14
    # the chosen window is the argmin over every window
    costs = {c: rl.msm_products(rl.digit_counts(uniform, c), c, "g1") for c in rl.WINDOWS}
    assert costs[cu] == min(costs.values())


def test_bound_ignores_the_port_window(monkeypatch):
    from icicle_snark_tpu_torch.ops import msm

    words = rl.as_words([7] * 100 + [R_MOD - 1] * 100)
    before = rl.prove_work(words, 1, 256)
    monkeypatch.setattr(msm, "choose_c", lambda *a, **k: 4)
    monkeypatch.setattr(msm, "choose_c_pre", lambda *a, **k: (4, 1))
    assert rl.prove_work(words, 1, 256) == before


def test_bound_is_the_larger_of_operations_and_bytes():
    t, by = rl.bound_seconds(rl.INT_MULS_PER_S, 0)
    assert (t, by) == (1.0, "operations")
    t, by = rl.bound_seconds(0, rl.HBM_BYTES_PER_S * 2)
    assert (t, by) == (2.0, "bytes")
    assert rl.MULS_PER_PRODUCT == 264
    assert rl.INT_MULS_PER_S == pytest.approx(64 * 132 * 1.98e9)
