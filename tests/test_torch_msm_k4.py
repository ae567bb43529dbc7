"""K4 accumulate as pieces and levels (plain versions on the CPU) on the
grouped G1 MSM's edge cases, with BUCKET_PIECE (L) patched small: a bucket
of exactly L and of L + 1 lanes, one scalar over every lane (several fold
levels), a bit-valued witness beside uniform h, all-zero scalars, (0, 0)
bases inside a split bucket, and the sliced route. Every case runs the
port's window sums and is held against the JAX package's grouped pipeline
(`_msm_g1_jit` window sums and the Horner step of `msm_g1_many`) as AFFINE points, and against
the refmath oracle. All cases share one shape, so JAX compiles once."""

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
SIZES = (12, 12, 10, 14)  # the A, B1, C and H groups of a prove
N = sum(SIZES)
S = R_MOD - 12345  # a full-width scalar with a nonzero digit in every window


def _aff(seed):
    rng = np.random.default_rng(seed)
    return [cv.g1_to_affine(cv.g1_mul(cv.G1_GEN, int(k))) for k in rng.integers(1, 1 << 20, size=N)]


def _uniform(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]


def _case(kind):
    """(scalars, affine bases, L, fold levels) of one edge case."""
    rng = np.random.default_rng(len(kind))
    aff = _aff(17)
    if kind in ("piece-L", "piece-L+1"):
        # group A: L or L + 1 lanes of one scalar, the rest zero: that
        # bucket holds the longest run of every window
        run = 4 if kind == "piece-L" else 5
        vals = [S] * run + [0] * (SIZES[0] - run) + _uniform(rng, N - SIZES[0])
        return vals, aff, 4, 1 if run == 4 else 2
    if kind == "one-scalar":
        # every lane of a group in one bucket per window: 14 -> 7 -> 4 -> 2
        return [S] * N, aff, 2, 4
    if kind == "bits-and-h":
        bits = [int(b) for b in rng.integers(0, 2, size=N - SIZES[3])]
        return bits + _uniform(rng, SIZES[3]), aff, 4, 2
    if kind == "zeros":
        return [0] * N, aff, 4, 1
    assert kind == "identity-in-split-bucket"
    # group H: one scalar over all 14 lanes, five of them at infinity, so
    # with L = 2 pieces start with, end with and hold only (0, 0)
    lo = N - SIZES[3]
    for i in (lo, lo + 1, lo + 4, lo + 9, N - 1):
        aff[i] = (0, 0)
    return _uniform(rng, lo) + [S] * SIZES[3], aff, 2, 4


def _port_records(aff):
    return msm.point_records((lb.ints_to_limbs([fq_to_mont(a[0]) for a in aff]),
                              lb.ints_to_limbs([fq_to_mont(a[1]) for a in aff])))


def _jax_groups(vals, aff):
    jx = jlb.ints_to_limbs_np([fq_to_mont(a[0]) for a in aff])
    jy = jlb.ints_to_limbs_np([fq_to_mont(a[1]) for a in aff])
    jsc = jlb.ints_to_limbs_np(vals)
    out, lo = [], 0
    for n_g in SIZES:
        out.append((jnp.asarray(jsc[:, lo:lo + n_g]),
                    (jnp.asarray(jx[:, lo:lo + n_g]), jnp.asarray(jy[:, lo:lo + n_g]))))
        lo += n_g
    return out


def _oracle(vals, aff):
    acc = cv.G1_ZERO
    for v, a in zip(vals, aff):
        acc = cv.g1_add(acc, cv.g1_mul(cv.g1_from_affine(a), v))
    return acc


def _affine_windows(ws, g):
    return [cv.g1_to_affine(p) for p in msm.window_points_to_host_g1(ws, g)]


def _check_against_jax_and_oracle(ws, vals, aff):
    groups = _jax_groups(vals, aff)
    jws = np.asarray(jmsm._msm_g1_jit(tuple(s for s, _ in groups), tuple(p for _, p in groups),
                                      C, 8))
    lo = 0
    for g, n_g in enumerate(SIZES):
        theirs = jmsm.window_points_to_host_g1(jws, g)
        assert _affine_windows(ws, g) == [cv.g1_to_affine(p) for p in theirs]
        got = msm.horner_combine(msm.window_points_to_host_g1(ws, g), C)
        assert cv.g1_eq(got, jmsm.horner_combine(theirs, C))  # as msm_g1_many finishes
        assert cv.g1_eq(got, _oracle(vals[lo:lo + n_g], aff[lo:lo + n_g]))
        lo += n_g


@pytest.mark.parametrize("kind", ["piece-L", "piece-L+1", "one-scalar", "bits-and-h", "zeros",
                                  "identity-in-split-bucket"])
def test_g1_accumulate_edges_match_jax_and_oracle(kind, monkeypatch):
    vals, aff, piece, levels = _case(kind)
    monkeypatch.setattr(msm, "BUCKET_PIECE", piece)
    scalars = lb.ints_to_limbs(vals)
    order, _negs, ends = msm.sort_windows(scalars, list(SIZES), C)
    plan = msm.bucket_fold_plan(ends, order.shape[0], len(SIZES), 1 << (C - 1), N)
    # no thread adds more than L inputs in any level
    assert len(plan) == levels
    assert all(int(length.max()) <= piece for _start, length in plan)
    runs = torch.diff(ends.to(torch.int64), dim=1, prepend=torch.zeros_like(ends[:, :1]))
    runs = runs.reshape(order.shape[0], len(SIZES), -1)[..., 1:]  # digit 0 is no bucket
    if kind.startswith("piece"):
        assert int(runs.max()) == (piece if kind == "piece-L" else piece + 1)
    ws = msm.msm_window_sums(scalars, SIZES, _port_records(aff), C).numpy()
    _check_against_jax_and_oracle(ws, vals, aff)


def test_g1_sliced_route_with_pieces_matches_direct_jax_and_oracle(monkeypatch):
    """The bit-valued case through `msm_windows_sliced` in slices of 20
    lanes (group boundaries inside slices, a tail padded by 12), with L,
    REDUCE_SEG and REDUCE_BLOCK patched small."""
    vals, aff, _piece, _levels = _case("bits-and-h")
    monkeypatch.setattr(msm, "BUCKET_PIECE", 2)
    monkeypatch.setattr(msm, "REDUCE_SEG", 4)
    monkeypatch.setattr(msm, "REDUCE_BLOCK", 4)
    scalars, records = lb.ints_to_limbs(vals), _port_records(aff)
    sliced = msm.msm_windows_sliced(scalars, SIZES, records, C, max_lanes=20).numpy()
    direct = msm.msm_window_sums(scalars, SIZES, records, C).numpy()
    for g in range(len(SIZES)):
        assert _affine_windows(sliced, g) == _affine_windows(direct, g)
    _check_against_jax_and_oracle(sliced, vals, aff)
