"""The port's MSM (K4 plain versions on the CPU) against the JAX package's
grouped window pipeline and the refmath oracle: window sums equal as
AFFINE points, final points equal, for G1 (grouped) and G2, with
full-width, skewed and edge-case scalars."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import R_MOD, fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def _g1_points(n, seed):
    rng = np.random.default_rng(seed)
    aff = [cv.g1_to_affine(cv.g1_mul(cv.G1_GEN, int(k))) for k in rng.integers(1, 1 << 20, size=n)]
    aff[2] = (0, 0)  # zkeys hold infinity points
    return aff


def _g2_points(n, seed):
    rng = np.random.default_rng(seed)
    aff = [cv.g2_to_affine(cv.g2_mul(cv.G2_GEN, int(k))) for k in rng.integers(1, 1 << 20, size=n)]
    aff[1] = ((0, 0), (0, 0))
    return aff


def _full_width(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    vals = [int.from_bytes(w.astype("<u4").tobytes(), "little") % R_MOD for w in words]
    vals[0], vals[1], vals[3] = R_MOD - 1, 0, 1
    vals[4] = vals[5] = vals[6]  # duplicates
    return vals


def _oracle_g1(vals, aff):
    acc = cv.G1_ZERO
    for v, a in zip(vals, aff):
        acc = cv.g1_add(acc, cv.g1_mul(cv.g1_from_affine(a), v))
    return acc


def _oracle_g2(vals, aff):
    acc = cv.G2_ZERO
    for v, a in zip(vals, aff):
        acc = cv.g2_add(acc, cv.g2_mul(cv.g2_from_affine(a), v))
    return acc


def _g1_port(aff):
    return (lb.ints_to_limbs([fq_to_mont(a[0]) for a in aff]),
            lb.ints_to_limbs([fq_to_mont(a[1]) for a in aff]))


def _g2_port(aff):
    return tuple(torch.stack([lb.ints_to_limbs([fq_to_mont(a[i][c]) for a in aff])
                              for c in range(2)]) for i in range(2))


def test_g1_grouped_window_sums_match_jax():
    """Two groups through one pipeline, c = 8: 40 lanes of full-width
    scalars and 24 lanes of one skewed scalar. Every window sum equals the
    JAX pipeline's as an affine point, and each MSM equals the JAX
    package's msm_g1_many."""
    aff = _g1_points(64, 3)
    vals = _full_width(64, 5)
    vals[40:] = [R_MOD - 12345] * 24
    sizes = [40, 24]
    c, k = 8, 8
    pts = _g1_port(aff)
    ws = msm.msm_window_sums(lb.ints_to_limbs(vals), sizes, msm.point_records(pts), c)
    assert ws.shape == (3, 8, 2, 32)

    jx = jlb.ints_to_limbs_np([fq_to_mont(a[0]) for a in aff])
    jy = jlb.ints_to_limbs_np([fq_to_mont(a[1]) for a in aff])
    jsc = jlb.ints_to_limbs_np(vals)
    jgroups = [(jnp.asarray(jsc[:, lo:hi]), (jnp.asarray(jx[:, lo:hi]), jnp.asarray(jy[:, lo:hi])))
               for lo, hi in ((0, 40), (40, 64))]
    jws = np.asarray(jmsm._msm_g1_jit(
        tuple(s for s, _ in jgroups), tuple(p for _, p in jgroups), c, k))
    jfinal = jmsm.msm_g1_many(jgroups, c=c, k=k)
    for g, (lo, hi) in enumerate(((0, 40), (40, 64))):
        mine = msm.window_points_to_host_g1(ws.numpy(), g)
        theirs = jmsm.window_points_to_host_g1(jws, g)
        assert [cv.g1_to_affine(p) for p in mine] == [cv.g1_to_affine(p) for p in theirs]
        got = msm.horner_combine(mine, c)
        assert cv.g1_eq(got, jfinal[g])
        assert cv.g1_eq(got, _oracle_g1(vals[lo:hi], aff[lo:hi]))


@pytest.mark.parametrize("kind", ["skewed", "zeros"])
def test_g1_skewed_scalars_match_oracle(kind):
    """One repeated scalar (every lane in one bucket per window: the
    longest accumulate runs) and all-zero scalars, c = 9."""
    aff = _g1_points(48, 7)
    vals = [R_MOD - 12345] * 48 if kind == "skewed" else [0] * 48
    c = 9
    ws = msm.msm_window_sums(lb.ints_to_limbs(vals), [48], msm.point_records(_g1_port(aff)), c)
    got = msm.horner_combine(msm.window_points_to_host_g1(ws.numpy(), 0), c)
    assert cv.g1_eq(got, _oracle_g1(vals, aff))


def test_g2_window_sums_match_jax():
    aff = _g2_points(16, 9)
    vals = _full_width(16, 10)
    c = 8
    pts = _g2_port(aff)
    ws = msm.msm_window_sums(lb.ints_to_limbs(vals), [16], msm.point_records(pts), c)
    assert ws.shape == (3, 2, 8, 1, 32)
    jpts = tuple(
        jnp.asarray(np.stack([jlb.ints_to_limbs_np([fq_to_mont(a[i][comp]) for a in aff])
                              for comp in range(2)], axis=1))
        for i in range(2)
    )
    jsc = jnp.asarray(jlb.ints_to_limbs_np(vals))
    jws = np.asarray(jmsm._msm_g2_jit((jsc,), (jpts,), c, 8))
    mine = msm.window_points_to_host_g2(ws.numpy(), 0)
    theirs = jmsm.window_points_to_host_g2(jws, 0)
    assert [cv.g2_to_affine(p) for p in mine] == [cv.g2_to_affine(p) for p in theirs]
    got = msm.horner_combine(mine, c, g2=True)
    assert cv.g2_eq(got, jmsm.msm_g2(jsc, jpts, c=c, k=8))
    assert cv.g2_eq(got, _oracle_g2(vals, aff))


def test_signed_digits_recombine():
    vals = _full_width(32, 12)
    for c in (8, 13, 16):
        ab, neg = msm.window_digits_signed(lb.ints_to_limbs(vals), c)
        assert int(ab.max()) <= 1 << (c - 1)
        signed = torch.where(neg, -ab, ab)
        back = [sum(int(signed[w, i]) << (c * w) for w in range(signed.shape[0]))
                for i in range(len(vals))]
        assert back == vals


def test_choose_c_counts_additions():
    """The model counts K4's additions (one mixed add per point lane and
    window, two adds per bucket in the reduce); it assumes scalars spread
    evenly below the group order r (the h coefficients of every prove are;
    a witness of small values leaves the high windows empty and takes
    fewer additions)."""
    assert 8 <= msm.choose_c(100, 4) <= msm.choose_c(431079, 4) <= 16
    # the fastest c measured on an H100: 13 at complex-100k, 16 at complex-1600k
    assert msm.choose_c(431079, 4) == 13
    assert msm.choose_c(100003, 1) == 13
    assert msm.choose_c(6897159, 4) == 16 and msm.choose_c(1600003, 1) == 16
    assert msm.choose_c(64, 1) == 8


@pytest.mark.parametrize("c", [13, 14, 15, 16])
def test_choose_c_top_window_of_uniform_scalars(c):
    """Scalars uniform below r fill only 2^(254 - c * floor(253 / c))
    buckets of the top window, and every lower window's whole range. The
    crowded top window no longer enters `choose_c`: K4 accumulate cuts its
    long runs into pieces of BUCKET_PIECE, so it only adds fold levels."""
    rng = np.random.default_rng(c)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(4096)]
    ab, _neg = msm.window_digits_signed(lb.ints_to_limbs(vals), c)
    top = 253 // c
    top_bits = 254 - top * c  # BN254 scalars are below the 254-bit r
    assert ab.shape[0] == -(-256 // c) and not ab[top + 1:].any()
    limit = min(1 << (c - 1), 1 << top_bits)
    assert limit // 2 < int(ab[top].max()) <= limit + 1
    assert int(ab[top - 1].max()) > 1 << (c - 2)
    order, _negs, ends = msm.sort_windows(lb.ints_to_limbs(vals), [4096], c)
    plan = msm.bucket_fold_plan(ends, order.shape[0], 1, 1 << (c - 1), 4096)
    inputs, levels = int(torch.diff(ends.to(torch.int64), dim=1).max()), 1
    while inputs > msm.BUCKET_PIECE:
        inputs, levels = -(-inputs // msm.BUCKET_PIECE), levels + 1
    assert len(plan) == levels
