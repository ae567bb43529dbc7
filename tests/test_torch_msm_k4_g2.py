"""K4 accumulate as pieces and levels (plain versions on the CPU) on the G2
MSM's edge cases, with BUCKET_PIECE (L) patched small: a bucket of exactly
L and of L + 1 lanes, one scalar over every lane (a single bucket holding
every lane of a window, several fold levels), a bit-valued witness,
all-zero scalars and (0, 0) bases inside a split bucket. Each is held
against the JAX package's `_msm_g2_jit` window sums (and `msm_g2`'s Horner
step) as AFFINE points, and against the refmath oracle. All cases share one
shape, so JAX compiles once."""

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

C = 8
N = 16
S = R_MOD - 12345


def _aff():
    rng = np.random.default_rng(19)
    return [cv.g2_to_affine(cv.g2_mul(cv.G2_GEN, int(k))) for k in rng.integers(1, 1 << 20, size=N)]


def _case(kind):
    """(scalars, affine bases, L, fold levels) of one edge case."""
    rng = np.random.default_rng(len(kind))
    aff = _aff()
    if kind in ("piece-L", "piece-L+1"):
        run = 4 if kind == "piece-L" else 5
        return [S] * run + [0] * (N - run), aff, 4, 1 if run == 4 else 2
    if kind == "one-scalar":
        return [S] * N, aff, 2, 4  # 16 -> 8 -> 4 -> 2 inputs per bucket
    if kind == "bits":
        return [1] + [int(b) for b in rng.integers(0, 2, size=N - 1)], aff, 4, 2
    if kind == "zeros":
        return [0] * N, aff, 4, 1
    assert kind == "identity-in-split-bucket"
    for i in (0, 1, 5, 10, N - 1):
        aff[i] = ((0, 0), (0, 0))
    return [S] * N, aff, 3, 3  # 16 -> 6 -> 2 inputs per bucket


def _coords(aff, i, comp):
    return [fq_to_mont(a[i][comp]) for a in aff]


@pytest.mark.parametrize("kind", ["piece-L", "piece-L+1", "one-scalar", "bits", "zeros",
                                  "identity-in-split-bucket"])
def test_g2_accumulate_edges_match_jax_and_oracle(kind, monkeypatch):
    vals, aff, piece, levels = _case(kind)
    monkeypatch.setattr(msm, "BUCKET_PIECE", piece)
    scalars = lb.ints_to_limbs(vals)
    order, _negs, ends = msm.sort_windows(scalars, [N], C)
    plan = msm.bucket_fold_plan(ends, order.shape[0], 1, 1 << (C - 1), N)
    assert len(plan) == levels
    assert all(int(length.max()) <= piece for _start, length in plan)
    records = msm.point_records(tuple(
        torch.stack([lb.ints_to_limbs(_coords(aff, i, comp)) for comp in range(2)])
        for i in range(2)))
    ws = msm.msm_window_sums(scalars, [N], records, C).numpy()

    jpts = tuple(jnp.asarray(np.stack([jlb.ints_to_limbs_np(_coords(aff, i, comp))
                                       for comp in range(2)], axis=1)) for i in range(2))
    jsc = jnp.asarray(jlb.ints_to_limbs_np(vals))
    jws = np.asarray(jmsm._msm_g2_jit((jsc,), (jpts,), C, 8))
    theirs = jmsm.window_points_to_host_g2(jws, 0)
    mine = [cv.g2_to_affine(p) for p in msm.window_points_to_host_g2(ws, 0)]
    assert mine == [cv.g2_to_affine(p) for p in theirs]
    got = msm.horner_combine(msm.window_points_to_host_g2(ws, 0), C, g2=True)
    assert cv.g2_eq(got, jmsm.horner_combine(theirs, C, g2=True))  # as msm_g2 finishes
    want = cv.G2_ZERO
    for v, a in zip(vals, aff):
        want = cv.g2_add(want, cv.g2_mul(cv.g2_from_affine(a), v))
    assert cv.g2_eq(got, want)
