"""K4 reduce as segments and one block per row (plain version on the CPU),
with REDUCE_SEG and REDUCE_BLOCK patched so that every stage does real
work (several segments per thread, a scan and trees over several threads),
held against the JAX package's grouped window sums (`_msm_g1_jit`) as
AFFINE points and against the refmath oracle; the tables of K4
accumulate for a single bucket holding every lane; and the K4 wrappers'
checks of their input."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import R_MOD, fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

SIZES = (20, 12)


@pytest.mark.parametrize("c", [8, 9])
def test_reduce_stages_match_jax_and_oracle(c, monkeypatch):
    """s = 4, nt = 4: H = 128 (c = 8) gives 32 segments a row, 8 to a
    thread; H = 256 (c = 9) 64 segments, 16 to a thread; two scan steps
    and two tree levels in either."""
    monkeypatch.setattr(msm, "REDUCE_SEG", 4)
    monkeypatch.setattr(msm, "REDUCE_BLOCK", 4)
    seg, n_seg, nt, q = msm.reduce_shape(1 << (c - 1))
    assert (seg, nt) == (4, 4) and q == n_seg // 4 >= 8
    rng = np.random.default_rng(c)
    n = sum(SIZES)
    aff = [cv.g1_to_affine(cv.g1_mul(cv.G1_GEN, int(k))) for k in rng.integers(1, 1 << 20, size=n)]
    aff[3] = (0, 0)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]
    vals[0], vals[1], vals[2] = R_MOD - 1, 1, 0
    xs = [fq_to_mont(a[0]) for a in aff]
    ys = [fq_to_mont(a[1]) for a in aff]
    records = msm.point_records((lb.ints_to_limbs(xs), lb.ints_to_limbs(ys)))
    ws = msm.msm_window_sums(lb.ints_to_limbs(vals), SIZES, records, c).numpy()

    jx, jy, jsc = (jlb.ints_to_limbs_np(v) for v in (xs, ys, vals))
    cut = ((0, SIZES[0]), (SIZES[0], n))
    jws = np.asarray(jmsm._msm_g1_jit(
        tuple(jnp.asarray(jsc[:, lo:hi]) for lo, hi in cut),
        tuple((jnp.asarray(jx[:, lo:hi]), jnp.asarray(jy[:, lo:hi])) for lo, hi in cut), c, 8))
    for g, (lo, hi) in enumerate(cut):
        mine = msm.window_points_to_host_g1(ws, g)
        assert [cv.g1_to_affine(p) for p in mine] == [
            cv.g1_to_affine(p) for p in jmsm.window_points_to_host_g1(jws, g)]
        want = cv.G1_ZERO
        for v, a in zip(vals[lo:hi], aff[lo:hi]):
            want = cv.g1_add(want, cv.g1_mul(cv.g1_from_affine(a), v))
        assert cv.g1_eq(msm.horner_combine(mine, c), want)


@pytest.mark.parametrize("seg,block", [(4, 4), (8, 2), (16, 128)])
def test_reduce_equals_weighted_bucket_sum(seg, block, monkeypatch):
    """msm_reduce on random projective buckets (and identities) equals
    sum_b b * B_b computed on host integers, row by row, c = 8."""
    monkeypatch.setattr(msm, "REDUCE_SEG", seg)
    monkeypatch.setattr(msm, "REDUCE_BLOCK", block)
    half, windows, groups = 128, 2, 1
    rng = np.random.default_rng(seg * block)
    pts = [cv.g1_mul(cv.G1_GEN, int(k)) for k in rng.integers(0, 1 << 20, size=windows * half)]
    pts[5] = pts[130] = cv.G1_ZERO
    aff = [cv.g1_to_affine(p) for p in pts]
    x = lb.ints_to_limbs([fq_to_mont(a[0]) for a in aff])
    y = lb.ints_to_limbs([fq_to_mont(a[1]) for a in aff])
    inf = lb.is_zero(x) & lb.is_zero(y)
    one = jc.identity(jc.G1_PLAIN, x.shape[-1], "cpu")[1]
    buckets = jc.point_stack(jc.pselect(inf, jc.identity(jc.G1_PLAIN, x.shape[-1], "cpu"),
                                        (x, y, one)))
    out = msm.msm_reduce(buckets, windows, groups, half).numpy()
    for w in range(windows):
        want = cv.G1_ZERO
        for b in range(1, half + 1):
            want = cv.g1_add(want, cv.g1_mul(pts[w * half + b - 1], b))
        assert cv.g1_eq(msm.window_points_to_host_g1(out, 0)[w], want)


@pytest.mark.parametrize("piece", [2, 3, 16])
def test_fold_plan_single_bucket_holding_every_lane(piece, monkeypatch):
    """One scalar over 1000 lanes: every window's lanes fall in one bucket.
    The plan cuts it into pieces of at most L, ceil(log_L(1000)) levels,
    each level's pieces covering its inputs once and in order, and the
    last level has one item per bucket."""
    monkeypatch.setattr(msm, "BUCKET_PIECE", piece)
    n, c = 1000, 8
    scalars = lb.ints_to_limbs([R_MOD - 12345] * n)
    order, _negs, ends = msm.sort_windows(scalars, [n], c)
    windows, half = order.shape[0], 1 << (c - 1)
    plan = msm.bucket_fold_plan(ends, windows, 1, half, n)
    assert len(plan) == math.ceil(math.log(n) / math.log(piece) - 1e-9)
    inputs = None
    for level, (start, length) in enumerate(plan):
        assert int(length.max()) <= piece and int(length.min()) >= 0
        if level < len(plan) - 1:
            assert int(length.min()) >= 1
        if inputs is not None:  # pieces of the previous level, in order
            covered = torch.repeat_interleave(start, length.to(torch.int64)) + torch.cat(
                [torch.arange(int(k)) for k in length])
            assert torch.equal(covered, torch.arange(inputs))
        inputs = start.shape[0]
    assert plan[-1][0].shape[0] == windows * half
    full = plan[-1][1] if len(plan) == 1 else plan[0][1]
    assert int(full.to(torch.int64).sum()) == int((ends[:, -1] - ends[:, 0]).sum())


@pytest.mark.parametrize("case", ["record-width", "order-shape", "ends-shape", "bucket-count",
                                  "segment-not-power-of-two", "meta-device"])
def test_k4_wrappers_refuse_bad_input(case, monkeypatch):
    """The wrappers check shapes and constants before any launch, and run
    the plain version only for CPU tensors."""
    n, c = 8, 8
    half = 1 << (c - 1)
    scalars = lb.ints_to_limbs(list(range(1, n + 1)))
    order, negs, ends = msm.sort_windows(scalars, [n], c)
    records = torch.zeros((n, 16), dtype=torch.int32)
    buckets = torch.zeros((3, 8, order.shape[0] * half), dtype=torch.int32)
    if case == "record-width":
        with pytest.raises(ValueError):
            msm.msm_accumulate(records[:, :12], order, negs, ends, 1, half)
    elif case == "order-shape":
        with pytest.raises(ValueError):
            msm.msm_accumulate(records, order, negs[:, :-1], ends, 1, half)
    elif case == "ends-shape":
        with pytest.raises(ValueError):
            msm.msm_accumulate(records, order, negs, ends[:, :-1], 1, half)
    elif case == "bucket-count":
        with pytest.raises(ValueError):
            msm.msm_reduce(buckets[..., :-1], order.shape[0], 1, half)
    elif case == "segment-not-power-of-two":
        monkeypatch.setattr(msm, "REDUCE_SEG", 6)
        with pytest.raises(ValueError):
            msm.msm_reduce(buckets, order.shape[0], 1, half)
    else:
        with pytest.raises(RuntimeError):
            msm.msm_reduce(buckets.to("meta"), order.shape[0], 1, half)
