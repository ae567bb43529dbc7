"""The port's MSM base precompute (K7's plain versions on the CPU) against
the JAX package: `precompute_bases` equals `precompute_bases_host` word for
word (G1 and G2, factors 2 and 4, infinity lanes), merged digit rows equal
`_merge_digit_windows`, an MSM over precomputed bases equals the plain one
and the refmath oracle, and `to_affine` / the field inverse equal
`to_affine_device` / `mont_inv` including 0 -> 0. The default plan at the
benchmark keys' lane counts is pinned."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curve import jcurve as jjc
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.prover import cache
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import Q, R_MOD, fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def _g1_aff(n, seed=3):
    rng = np.random.default_rng(seed)
    aff = [cv.g1_to_affine(cv.g1_mul(cv.G1_GEN, int(k))) for k in rng.integers(1, 1 << 40, size=n)]
    aff[1] = (0, 0)
    return aff


def _g2_aff(n, seed=4):
    rng = np.random.default_rng(seed)
    aff = [cv.g2_to_affine(cv.g2_mul(cv.G2_GEN, int(k))) for k in rng.integers(1, 1 << 40, size=n)]
    aff[0] = ((0, 0), (0, 0))
    return aff


def _port_g1(aff):
    return tuple(lb.ints_to_limbs([fq_to_mont(a[i]) for a in aff]) for i in range(2))


def _port_g2(aff):
    return tuple(torch.stack([lb.ints_to_limbs([fq_to_mont(a[i][c]) for a in aff])
                              for c in range(2)]) for i in range(2))


def _jax_np_g1(aff):
    return tuple(jlb.ints_to_limbs_np([fq_to_mont(a[i]) for a in aff]) for i in range(2))


def _jax_np_g2(aff):
    return tuple(np.stack([jlb.ints_to_limbs_np([fq_to_mont(a[i][c]) for a in aff])
                           for c in range(2)], axis=1) for i in range(2))


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_precompute_bases_equals_host_oracle_word_for_word(g2, factor):
    """The prove's own plan, c = 13: shifts of 130 (f = 2) and 65 (f = 4)
    doublings. JAX's host oracle stands in for its jitted version."""
    c, n = 13, 4
    aff = _g2_aff(n) if g2 else _g1_aff(n)
    got = msm.precompute_bases(_port_g2(aff) if g2 else _port_g1(aff),
                               jc.G2 if g2 else jc.G1, c, factor)
    want = jmsm.precompute_bases_host(_jax_np_g2(aff) if g2 else _jax_np_g1(aff), c, factor, g2=g2)
    for mine, theirs in zip(got, want):
        assert mine.shape[-1] == n * factor
        if g2:  # port (2, 8, n*f) -> JAX (16, 2, n*f)
            mine = mine.transpose(0, 1)
        assert np.array_equal(lb.to_jax_limbs(mine.contiguous()), theirs)
    # factor 1 hands the points back
    assert msm.precompute_bases(got, jc.G1, c, 1) is got


@pytest.mark.parametrize("c,factor", [(8, 2), (13, 4), (13, 3), (16, 4)])
def test_merged_digits_equal_jax(c, factor):
    rng = np.random.default_rng(c + factor)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(9)]
    digits, neg = msm.window_digits_signed(lb.ints_to_limbs(vals), c)
    jd, jn = jmsm.window_digits_signed(jnp.asarray(jlb.ints_to_limbs_np(vals)), c)
    wp = msm.merged_windows(c, factor)
    assert wp == -(-digits.shape[0] // factor)
    got = msm.merge_digit_windows(digits, factor, 0)
    assert got.shape == (wp, 9 * factor)
    assert np.array_equal(got.numpy(), np.asarray(jmsm._merge_digit_windows(jd, factor, wp, 0)))
    assert np.array_equal(msm.merge_digit_windows(neg, factor, False).numpy(),
                          np.asarray(jmsm._merge_digit_windows(jn, factor, wp, False)))
    # merged window j, lane i*f + m is window j + m*wp of lane i; dead slots are 0
    for m in range(factor):
        rows = digits[m * wp:(m + 1) * wp]
        assert torch.equal(got[:rows.shape[0], m::factor], rows)
        assert not got[rows.shape[0]:, m::factor].any()


@pytest.mark.parametrize("factor", [2, 4])
def test_g1_msm_with_precompute_equals_plain_and_oracle(factor):
    c, sizes = 8, [10, 6]
    aff = _g1_aff(16, seed=9)
    rng = np.random.default_rng(factor)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(16)]
    vals[0], vals[2], vals[3] = R_MOD - 1, 0, 1
    scalars, points = lb.ints_to_limbs(vals), _port_g1(aff)
    pre = msm.precompute_bases(points, jc.G1, c, factor)
    ws = msm.msm_window_sums(scalars, sizes, msm.point_records(pre), c, precompute=factor)
    assert ws.shape == (3, 8, 2, msm.merged_windows(c, factor))
    plain = msm.msm_window_sums(scalars, sizes, msm.point_records(points), c)
    sliced = msm.msm_windows_sliced(scalars, sizes, msm.point_records(pre), c, max_lanes=6 * factor,
                                    precompute=factor)
    lo = 0
    for g, n_g in enumerate(sizes):
        want = cv.G1_ZERO
        for v, a in zip(vals[lo:lo + n_g], aff[lo:lo + n_g]):
            want = cv.g1_add(want, cv.g1_mul(cv.g1_from_affine(a), v))
        for stacked in (ws, plain, sliced):
            got = msm.horner_combine(msm.window_points_to_host_g1(stacked.numpy(), g), c)
            assert cv.g1_eq(got, want)
        lo += n_g
    with pytest.raises(ValueError):
        msm.msm_window_sums(scalars, sizes, msm.point_records(points), c, precompute=factor)


def test_g2_msm_with_precompute_equals_oracle():
    c, factor = 8, 2
    aff = _g2_aff(6, seed=11)
    rng = np.random.default_rng(12)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(6)]
    pre = msm.precompute_bases(_port_g2(aff), jc.G2, c, factor)
    ws = msm.msm_window_sums(lb.ints_to_limbs(vals), [6], msm.point_records(pre), c,
                             precompute=factor)
    want = cv.G2_ZERO
    for v, a in zip(vals, aff):
        want = cv.g2_add(want, cv.g2_mul(cv.g2_from_affine(a), v))
    got = msm.horner_combine(msm.window_points_to_host_g2(ws.numpy(), 0), c, g2=True)
    assert cv.g2_eq(got, want)


def test_choose_c_with_factor():
    assert msm.choose_c(431079, 4, 1) == msm.choose_c(431079, 4) == 13
    for f in (2, 4):
        assert 8 <= msm.choose_c(100003, 1, f) <= 16
    c, f = msm.choose_c_pre(100003, groups=1, g2=True)
    assert f == msm.MSM_PRE_DEFAULT[1] and c == msm.choose_c(100003, 1, f)
    assert msm.merged_windows(13, 4) == 5 and msm.merged_windows(16, 2) == 8


@pytest.mark.parametrize("n_vars,n_public,log_n,g1_lanes", [
    (1600003, 1, 21, 6897159),  # complex-1600k
    (936533, 9, 20, 3858165),   # anon_aadhaar-1536
], ids=["complex-1600k", "anon_aadhaar-1536"])
def test_default_plan_at_the_benchmark_keys(n_vars, n_public, log_n, g1_lanes):
    """The plan a key of each benchmark cell's shape loads with, from its
    lane counts alone: G1 (16, 1) and G2 (16, 1)."""
    hdr = SimpleNamespace(n_vars=n_vars, n_public=n_public, domain_size=1 << log_n)
    assert 3 * n_vars - (n_public + 1) + (1 << log_n) == g1_lanes
    assert cache.default_msm_plan(hdr) == ((16, 1), (16, 1))


def test_field_inverse_equals_mont_inv():
    rng = np.random.default_rng(21)
    vals = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(6)]
    vals[0], vals[1], vals[2] = 0, 1, Q - 1
    mont = [fq_to_mont(v) for v in vals]
    got = jc.G1.inv(lb.ints_to_limbs(mont))
    want = jax.jit(lambda a: jlb.mont_inv(a, jlb.FQ_SPEC))(jnp.asarray(jlb.ints_to_limbs_np(mont)))
    assert np.array_equal(lb.to_jax_limbs(got), np.asarray(want))
    ints = lb.limbs_to_ints(got)
    assert ints[0] == 0  # 0 -> 0
    assert ints[1:] == [fq_to_mont(pow(v, -1, Q)) for v in vals[1:]]


def test_to_affine_equals_to_affine_device_g1():
    aff = _g1_aff(6, seed=13)
    x, y = _port_g1(aff)
    z = jc.identity(jc.G1, 6, "cpu")[1]
    p = jc.pdbl_k(jc.G1, (x, y, torch.where(lb.is_zero(x) & lb.is_zero(y), torch.zeros_like(z), z)), 3)
    gx, gy = jc.to_affine(jc.G1, p)
    jp = tuple(jnp.asarray(lb.to_jax_limbs(t)) for t in p)
    wx, wy = jax.jit(lambda q: jmsm.to_affine_device(q, jjc.FqOps))(jp)
    assert np.array_equal(lb.to_jax_limbs(gx), np.asarray(wx))
    assert np.array_equal(lb.to_jax_limbs(gy), np.asarray(wy))
    host = [None if a == (0, 0) else cv.g1_to_affine(cv.g1_mul(cv.g1_from_affine(a), 8)) for a in aff]
    want = [(0, 0) if h is None else (fq_to_mont(h[0]), fq_to_mont(h[1])) for h in host]
    assert list(zip(lb.limbs_to_ints(gx), lb.limbs_to_ints(gy))) == want


def test_to_affine_g2_equals_host_and_rejects_bad_shapes():
    aff = _g2_aff(4, seed=15)
    x, y = _port_g2(aff)
    one = jc.identity(jc.G2, 4, "cpu")[1]
    inf = jc.G2.is_zero_lanes(x) & jc.G2.is_zero_lanes(y)
    p = jc.pdbl_k(jc.G2, (x, y, torch.where(inf, torch.zeros_like(one), one)), 2)
    gx, gy = jc.to_affine(jc.G2, p)
    for i, a in enumerate(aff):
        want = ((0, 0), (0, 0)) if a == ((0, 0), (0, 0)) else cv.g2_to_affine(
            cv.g2_mul(cv.g2_from_affine(a), 4))
        got = tuple(tuple(lb.limbs_to_ints(t[comp][:, i:i + 1])[0] for comp in range(2))
                    for t in (gx, gy))
        assert got == tuple(tuple(fq_to_mont(v) for v in coord) for coord in want)
    with pytest.raises(ValueError):
        jc.to_affine(jc.G1, p)
    with pytest.raises(ValueError):
        jc.pdbl_k(jc.G2, (x, y, one[..., :2]), 1)
