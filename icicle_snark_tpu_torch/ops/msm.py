"""Pippenger multi-scalar multiplication (kernels K4, K6, K7).

The bucket method as the reference runs it on a GPU, over the data layout
of icicle_snark_tpu/ops/msm.py:

  1. signed c-bit window digits of the scalars (msm.py:167), written by
     `window_pairs` (K19, csrc/msm_sort.cu) as one (key, value) pair of
     int32 words per (window, lane): key = w * KR + group * (H + 1) +
     |digit|, KR = (G + 1)(H + 1), H = 2^(c-1); value = lane | sign << 31;
  2. `sort_pairs` (K19): one stable radix sort of every window's pairs over
     the key bits they use (22 at c = 16), each window's row in place, and
     bucket ends by searchsorted (`sort_windows`);
  3. `msm_accumulate` (K4, csrc/msm.cu): every bucket's run of sorted lanes
     cut into pieces of at most BUCKET_PIECE points, one thread per piece,
     the pieces' sums folded the same way until one sum per bucket is left
     (`bucket_fold_plan`); y negated for negative digits;
  4. `msm_reduce` (K4, csrc/msm_reduce.cu): sum_b b * bucket_b per (window,
     group), by segments of REDUCE_SEG buckets and one block per row;
  5. Horner over the windows on the host (Python ints).

All G1 MSMs of a prove run as ONE pipeline over group-concatenated lanes
(the batched mode of the JAX package); the window sums come back stacked
(3, coords..., G, W) in Montgomery form, G1 coords (8,), G2 (2, 8).
Scalars are raw integers (8, n) int32 (the witness and h values); points
are the lane-major records of `point_records`.

Two variants of the JAX package's large-circuit path ride on the same
kernels:
  * sliced (`msm_windows_sliced`): past the lane cap the concatenated
    lanes are cut into fixed-width slices, each slice runs steps 1-4 with
    per-lane group ids, and `sum_windows` (K6) adds the slices' window
    sums in one launch;
  * precomputed bases (`precompute_bases`, K7): with factor f the key holds
    f affine copies 2^(c*wp*m) * P of every base, interleaved at lane
    i*f + m, and the W = ceil(256/c) digit windows merge into
    wp = ceil(W/f) windows over f times the lanes.

Every BN254 MSM (the proves, and the op surface `msm_g1`, `msm_g1_many`,
`msm_g2` with config.MSMConfig) is routed by `window_sums`, the one choice
of in core or sliced, and combined on the host by `host_points` (step 5).

The other curves (curves/device.py) run steps 1-4 over their own point
types: a `PointGroup` names the field-op tables, the coordinate shape and
the kernels (K13, csrc/msm_<curve>.cu: K4's accumulate and segments
templates at the curve's types, then the rows stage as a tree, csrc/
msm_kernels_n.cuh, `msm_reduce_n_plain`), and the scalar width comes from
the scalars' word count (256 bits for the bls12 Fr, 384 for the bw6-761 Fr,
as the JAX package's 16 * nlimb). BN254 calls pass `g2` as a bool, as
before.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels, trace
from . import point_programs as pprog
from ..curve import jcurve as jc
from ..errors import InvalidArgument
from ..fields.limbs import NLIMB
from ..refmath import curve as rcv
from ..refmath.field import fq_from_mont

SCALAR_BITS = 256
# K4 accumulate: the most points (level 0) or partial sums (later levels)
# one thread adds in one level.
BUCKET_PIECE = 16
# K4 reduce: buckets per thread of the segments stage, and threads of the
# block that finishes one (window, group) row (at most 256: the G2 rows
# kernel takes 255 registers a thread). Set by measurement on an H100
# (PERF.md, the K4 sweep of chip_smoke.py).
REDUCE_SEG = 16
REDUCE_BLOCK = 256
# K13 reduce: buckets a thread of the segments stage sums (min(16, H)); the
# tree above the segments halves the runs of a row per level.
REDUCE_SEG_N = 16
# Items one plain-torch accumulate step takes at a time (bounds the plain
# version's temporaries at the full-size MSMs).
PLAIN_CHUNK = 1 << 21


# Point lanes one in-core MSM pipeline may hold. Per point lane the
# pipeline keeps, for each of W windows: K19's key and value (2 x int32)
# and the radix sort's second buffer of both, then the int32 order K4 reads
# (the sorted values' words, masked in place) and a sign byte: 17 bytes,
# 272 per lane at W = 16 (c = 16) and 340 at W = 20 (c = 13), plus cub's
# scratch, under a byte; K4's first level adds, per BUCKET_PIECE lane-windows,
# a table entry (12 bytes, about 40 while it is built) and a partial sum
# (96 bytes G1, 192 G2), under 16 bytes per lane-window; plus the affine
# record (64 bytes G1, 128 G2): 1 KiB per lane covers both. 2^25 lanes are
# then 32 GiB of an 80 GB card, which leaves room for the proving key, the
# NTT batch and the allocator's slack. The G2 MSM takes half the lanes, as
# in the JAX package (`window_sums`).
MSM_MAX_LANES = 1 << 25
# Precompute factor of the default plan (G1, G2). Measured on an H100
# (PERF.md), factor 2 took 3 to 7 % off the window sums at the same
# window size, and 5 % off a complex-1600k prove, for twice the resident
# bases and a longer cache build: the default stays 1.
MSM_PRE_DEFAULT = (1, 1)


def merged_windows(c: int, factor: int = 1, bits: int = SCALAR_BITS) -> int:
    """Windows left after merging: wp = ceil(ceil(bits / c) / factor)."""
    return -(-(-(-bits // c)) // factor)


# What one bucket costs K4 reduce, in units of one mixed add of K4
# accumulate: two complete adds per bucket in the segments stage.
REDUCE_WEIGHT = 2


def choose_c(n: int, groups: int = 1, factor: int = 1, bits: int = SCALAR_BITS) -> int:
    """Window size that minimises K4's modelled time (c in 8..16; signed
    digits need c >= 8): wp merged windows, each with one mixed add per
    point lane (n * factor, dead slots included) in the accumulate and
    REDUCE_WEIGHT per bucket (groups * H) in the reduce. No thread of
    either kernel walks a bucket's run or a row's segments in order, so
    the longest run does not enter the model. On an H100 it picks the
    fastest c of 12..16 at both circuits of PERF.md (chip_smoke.py
    time_msm_plans)."""
    best_c, best_cost = 8, None
    for c in range(8, 17):
        half = 1 << (c - 1)
        cost = merged_windows(c, factor, bits) * (n * factor + REDUCE_WEIGHT * groups * half)
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def choose_c_pre(n: int, groups: int = 1, g2: bool = False) -> tuple:
    """The default (window size, precompute factor) of a fixed-base MSM
    (icicle_snark_tpu/ops/msm.py choose_c_pre): the measured factor and the
    window size that goes with it."""
    factor = MSM_PRE_DEFAULT[1 if g2 else 0]
    return choose_c(n, groups, factor), factor


def window_digits_signed(scalars: torch.Tensor, c: int):
    """(words, n) int32 scalars -> (abs (W, n) int64 in [0, 2^(c-1)], neg
    (W, n) bool), W = ceil(32 words / c): balanced digits, the carry moving
    into the next window. BN254 scalars below 2^254 never carry out of the
    top window for c >= 8, nor do scalars below r of the other curves
    (tests/test_torch_curves_msm.py)."""
    s = scalars.to(torch.int64) & 0xFFFFFFFF
    words = s.shape[0]
    n_windows = -(-(32 * words) // c)
    mask, half, full = (1 << c) - 1, 1 << (c - 1), 1 << c
    carry = torch.zeros_like(s[0])
    outs_abs, outs_neg = [], []
    for w in range(n_windows):
        word, off = divmod(w * c, 32)
        d = (s[word] >> off) if word < words else torch.zeros_like(carry)
        if off + c > 32 and word + 1 < words:
            d = d | (s[word + 1] << (32 - off))
        d = (d & mask) + carry
        neg = d > half
        carry = neg.to(torch.int64)
        outs_abs.append(torch.where(neg, full - d, d))
        outs_neg.append(neg)
    return torch.stack(outs_abs), torch.stack(outs_neg)


@dataclass(frozen=True)
class PointGroup:
    """The point type of one MSM pipeline: its field-op tables for the card
    and for the plain versions (curve/jcurve.py's interface), and the
    kernels' selector: curve -1 is BN254 (K4), 0, 1, 2 are bls12-377,
    bls12-381 and bw6-761 (K13); g2 picks the group within the curve."""

    name: str
    ops: object
    plain: object
    g2: bool
    curve: int = -1

    @property
    def coords(self) -> tuple:
        """Shape of one coordinate before the lane axis: (words,) or (2, words)."""
        return self.ops.coords

    @property
    def words(self) -> int:
        """32-bit words of one coordinate (a record holds two)."""
        return int(np.prod(self.coords))


BN254_G1 = PointGroup("bn254_g1", jc.G1, jc.G1_PLAIN, False)
BN254_G2 = PointGroup("bn254_g2", jc.G2, jc.G2_PLAIN, True)


def as_group(g2) -> PointGroup:
    """BN254's G1 / G2 for a bool, else the PointGroup given."""
    if isinstance(g2, PointGroup):
        return g2
    return BN254_G2 if g2 else BN254_G1


def _ops(g2, plain: bool):
    grp = as_group(g2)
    return grp.plain if plain else grp.ops


# ---------------------------------------------------------------- K4: accumulate

def point_records(points) -> torch.Tensor:
    """Affine (x, y), each (words, n) (Fq coordinates) or (2, words, n) (Fq2)
    limb-major, -> the lane-major records K4 and K13 read: (n, 2 words)
    int32, x then y, for Fq; (n, 4 words), x.c0, x.c1, y.c0, y.c1, for Fq2.
    One point is one row: 64 / 128 bytes for BN254 G1 / G2, 96 / 192 for
    bls12 G1 / G2, 192 for both bw6-761 groups."""
    x, y = points
    return torch.cat([x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])]).T.contiguous()


def _record_coords(rec: torch.Tensor, g2):
    """(k, 2 words) records -> affine (x, y) limb-major, as point_records' input."""
    coords = as_group(g2).coords
    t = rec.T
    half = t.shape[0] // 2
    return t[:half].reshape(coords + (-1,)), t[half:].reshape(coords + (-1,))


def bucket_fold_plan(ends, windows: int, groups: int, half: int, total: int) -> list:
    """The addition tables of K4 accumulate, one (start, len) pair of
    tensors per level. Bucket t = (w * G + g) * H + b - 1 is the run of
    sorted positions [ends[w, key - 1], ends[w, key]), key = g * (H + 1) + b.
    While some bucket has more than L = BUCKET_PIECE inputs, each bucket's
    inputs are cut into pieces of at most L (item k of a bucket starts at
    k * L), one item per piece, and the next level's inputs are those
    pieces' sums; the last level has one item per bucket, an empty one of
    length 0. Level 0 starts index the flattened (W * total) sorted
    positions, later levels the previous level's items."""
    piece = BUCKET_PIECE
    dev = ends.device
    nbk = windows * groups * half
    t = torch.arange(nbk, device=dev)
    w = t // (groups * half)
    rem = t % (groups * half)
    key = (rem // half) * (half + 1) + rem % half + 1
    e = ends.to(torch.int64)
    start = w * total + e[w, key - 1]
    cnt = e[w, key] - e[w, key - 1]
    levels = []
    while True:
        pieces = (cnt + piece - 1) // piece
        longest, n_items = torch.stack([cnt.max(), pieces.sum()]).tolist()
        if longest <= piece:
            levels.append((start, cnt.to(torch.int32)))
            return levels
        bucket = torch.repeat_interleave(torch.arange(nbk, device=dev), pieces,
                                         output_size=n_items)
        first = torch.cumsum(pieces, 0) - pieces
        k = torch.arange(n_items, device=dev) - first[bucket]
        levels.append((start[bucket] + k * piece,
                       torch.clamp(cnt[bucket] - k * piece, max=piece).to(torch.int32)))
        start, cnt = first, pieces


def g2_jacobian(g2, affine: bool) -> bool:
    """Whether an accumulate level runs on Jacobian mixed additions: BN254
    G2's level 0 (csrc/fq2_lazy.cuh lz_jstep)."""
    return affine and as_group(g2) is BN254_G2


def _jacobian_level(ops, load, st, ln, branches):
    """The items of one BN254 G2 level-0 chunk as the kernel adds them: from
    the identity (Z = 0), each record (x, y) is skipped if it is (0, 0)
    ("skip"), taken as (x, y, 1) by a sum at the identity ("load"), else
    added by jcurve.jmadd ("add"; "cancel" where the sum's Z becomes 0), or
    doubled by jcurve.jdbl where it equals the sum ("double"). Stored
    homogeneous by jcurve.jac_to_proj. The kernel's first add after a load
    takes jmadd's Z = 1 form (mmadd-2007-bl), whose values jmadd gives at
    Z = 1. `branches`, a dict, counts the steps of each kind."""
    m, dev = st.shape[0], st.device
    acc = jc.identity(ops, m, dev)
    one = jc.identity(ops, 1, dev)[1]
    for r in range(int(ln.max()) if m else 0):
        act = torch.nonzero(ln > r).squeeze(1)
        cur = tuple(a[..., act] for a in acc)
        x, y = load(st[act] + r)
        skip = ops.is_zero_lanes(x) & ops.is_zero_lanes(y)
        fresh = ~skip & ops.is_zero_lanes(cur[2])
        new, same = jc.jmadd(ops, cur, (x, y))
        same &= ~skip & ~fresh
        dbl = torch.nonzero(same).squeeze(1)
        if dbl.numel():
            for a, v in zip(new, jc.jdbl(ops, tuple(c[..., dbl] for c in cur))):
                a[..., dbl] = v
        new = jc.pselect(fresh, (x, y, one.expand(x.shape)), new)
        new = jc.pselect(skip, cur, new)
        if branches is not None:
            added = ~skip & ~fresh & ~same
            cancel = added & ops.is_zero_lanes(new[2])
            for key, mask in (("skip", skip), ("load", fresh), ("add", added & ~cancel),
                              ("double", same), ("cancel", cancel)):
                branches[key] = branches.get(key, 0) + int(mask.sum())
        for a, v in zip(acc, new):
            a[..., act] = v
    return jc.point_stack(jc.jac_to_proj(ops, acc))


def msm_bucket_sums_plain(g2, affine: bool, src, order, negs, start, length, branches=None):
    """Plain version of one K4 / K13 accumulate level (csrc/msm_kernels.cuh), in the
    kernel's order of additions: item i adds length[i] inputs from start[i]
    on. affine: src the (total, words) records, order/negs the flattened
    (W * total) sorted lanes and signs; the first point (y negated for a
    negative digit; (0, 0) is the identity) starts the sum, the others are
    mixed-added (BN254 G2 in Jacobian coordinates, `_jacobian_level`, whose
    steps `branches` counts). Otherwise src is the previous level's
    (3, coords..., m) partial sums, the first starts the sum and the others
    are added. Returns (3, coords..., n_items). Items are taken PLAIN_CHUNK
    at a time. g2: a bool for BN254's groups, or a PointGroup."""
    ops = _ops(g2, True)
    n = start.shape[0]
    dev = start.device
    out = []
    for lo in range(0, n, PLAIN_CHUNK):
        st = start[lo:lo + PLAIN_CHUNK]
        ln = length[lo:lo + PLAIN_CHUNK].to(torch.int64)
        m = st.shape[0]

        def load(pos):
            if affine:
                x, y = _record_coords(src[order[pos].to(torch.int64)], g2)
                return x, torch.where(negs[pos], ops.neg(y), y)
            return tuple(a[..., pos] for a in jc.point_unstack(src))

        if g2_jacobian(g2, affine):
            out.append(_jacobian_level(ops, load, st, ln, branches))
            continue
        acc = jc.identity(ops, m, dev)
        some = torch.nonzero(ln > 0).squeeze(1)
        if some.numel():
            first = load(st[some])
            if affine:
                x, y = first
                ident = jc.identity(ops, some.numel(), dev)
                inf = ops.is_zero_lanes(x) & ops.is_zero_lanes(y)
                first = jc.pselect(inf, ident, (x, y, ident[1]))
            for a, v in zip(acc, first):
                a[..., some] = v
        for r in range(1, int(ln.max())):
            act = torch.nonzero(ln > r).squeeze(1)
            cur = tuple(a[..., act] for a in acc)
            nxt = load(st[act] + r)
            new = jc.pmadd(ops, cur, nxt) if affine else jc.padd(ops, cur, nxt)
            for a, v in zip(acc, new):
                a[..., act] = v
        out.append(jc.point_stack(acc))
    return torch.cat(out, dim=-1)


def msm_bucket_sums(g2, affine: bool, src, order, negs, start, length):
    """One accumulate level (see msm_bucket_sums_plain) on the card: K4 for
    BN254, K13 for the other curves' groups."""
    grp = as_group(g2)
    n = start.shape[0]
    if affine:
        if src.dim() != 2 or src.shape[1] != 2 * grp.words or order.shape != negs.shape:
            raise ValueError("msm_bucket_sums: want (total, words) records and matching order/negs")
    elif tuple(src.shape[:-1]) != (3,) + grp.coords:
        raise ValueError("msm_bucket_sums: want (3, coords..., m) partial sums")
    if start.shape != (n,) or length.shape != (n,) or start.dtype != torch.int64 \
            or length.dtype != torch.int32 or src.dtype != torch.int32:
        raise ValueError("msm_bucket_sums: inconsistent tables")
    if src.device.type == "cpu":
        return msm_bucket_sums_plain(g2, affine, src, order, negs, start, length)
    if src.device.type != "cuda":
        raise RuntimeError(f"msm_bucket_sums: unsupported device {src.device}")
    src, start, length = src.contiguous(), start.contiguous(), length.contiguous()
    order = order.to(torch.int32).contiguous()
    negs = negs.to(torch.bool).contiguous()
    out = torch.empty((3,) + grp.coords + (n,), dtype=torch.int32, device=src.device)
    n_src = src.shape[0] if affine else src.shape[-1]
    args = (int(grp.g2), int(affine), out.data_ptr(), src.data_ptr(), n_src, order.data_ptr(),
            negs.data_ptr(), start.data_ptr(), length.data_ptr(), n)
    if grp.curve < 0:
        kernels.MSM_ACCUMULATE.launch(
            *args, variant="g2_jacobian" if g2_jacobian(grp, affine) else None)
    else:
        kernels.MSM_ACCUMULATE_N.launch(grp.curve, *args)
    return out


def _records_group(records, group):
    """The given group, or BN254's by the record width (16 or 32 words)."""
    return as_group(records.shape[1] == 32) if group is None else group


def _accumulate(records, order, negs, ends, groups: int, half: int, level_fn, group):
    windows, total = order.shape
    order, negs = order.reshape(-1), negs.reshape(-1)
    src, affine = records, True
    for start, length in bucket_fold_plan(ends, windows, groups, half, total):
        if g2_jacobian(group, affine):
            trace.count("g2_jacobian", start.shape[0])
        src = level_fn(group, affine, src, order, negs, start, length)
        affine = False
    return src


def _check_accumulate(records, order, negs, ends, groups, half, group):
    windows, total = order.shape
    if (records.dim() != 2 or records.shape[1] != 2 * group.words
            or records.shape[0] != total
            or records.dtype != torch.int32 or negs.shape != order.shape
            or ends.shape != (windows, groups * (half + 1))):
        raise ValueError("msm_accumulate: inconsistent shapes")


def msm_accumulate_plain(records, order, negs, ends, groups: int, half: int, group=None):
    """Plain version of K4 / K13 accumulate: every level in plain torch."""
    group = _records_group(records, group)
    _check_accumulate(records, order, negs, ends, groups, half, group)
    return _accumulate(records, order, negs, ends, groups, half, msm_bucket_sums_plain, group)


def msm_accumulate(records, order, negs, ends, groups: int, half: int, group=None):
    """Bucket sums of one MSM pipeline (all windows and groups).

    records: (total, 2 words) affine points (point_records): (total, 16) G1
    or (total, 32) G2 of BN254 when `group` is None, else of `group`;
    order: (W, total) int32 lane order of each window sorted by key;
    negs: (W, total) bool digit signs in that order;
    ends: (W, G*(H+1)) int32, lanes with key <= k.
    Returns (3, coords..., W*G*H) projective bucket sums (bucket b at b-1).
    One launch per level of bucket_fold_plan (K4 for BN254, K13 else)."""
    group = _records_group(records, group)
    _check_accumulate(records, order, negs, ends, groups, half, group)
    if records.device.type == "cpu":
        return msm_accumulate_plain(records, order, negs, ends, groups, half, group)
    if records.device.type != "cuda":
        raise RuntimeError(f"msm_accumulate: unsupported device {records.device}")
    return _accumulate(records, order, negs, ends, groups, half, msm_bucket_sums, group)


# ---------------------------------------------------------------- K4: reduce

def reduce_shape(half: int) -> tuple:
    """(s, n_seg, nt, q) of K4 reduce for H = half buckets: segments of
    s = min(REDUCE_SEG, H) buckets, n_seg = H / s of them per row, blocks of
    nt = min(REDUCE_BLOCK, n_seg) threads owning q = n_seg / nt each."""
    seg = min(REDUCE_SEG, half)
    n_seg = half // seg
    nt = min(REDUCE_BLOCK, n_seg)
    return seg, n_seg, nt, n_seg // nt


def _lanes(p, idx):
    return tuple(a[..., idx] for a in p)


def msm_reduce_segments_plain(ops, buckets, rows: int, half: int, seg: int):
    """Plain version of K4 reduce stage 0: (S, T) per (row, segment)."""
    n_seg = half // seg
    t = torch.arange(rows * n_seg, device=buckets.device)
    base = (t // n_seg) * half + (t % n_seg) * seg
    b = jc.point_unstack(buckets)
    run = _lanes(b, base + seg - 1)
    tri = run
    for i in range(seg - 2, -1, -1):
        run = jc.padd(ops, run, _lanes(b, base + i))
        tri = jc.padd(ops, tri, run)
    return run, tri


def msm_reduce_rows_plain(ops, seg_s, seg_t, windows: int, groups: int, n_seg: int, nt: int,
                          seg: int):
    """Plain version of K4 reduce stage 1, lane (row, u) for thread u of a
    row's block, in the kernel's order of additions."""
    rows = windows * groups
    q = n_seg // nt
    dev = seg_s[0].device
    lane = torch.arange(rows * nt, device=dev)
    u = lane % nt
    first = (lane // nt) * n_seg + u * q
    sig, tau = _lanes(seg_s, first), _lanes(seg_t, first)
    for r in range(1, q):
        sig = jc.padd(ops, sig, _lanes(seg_s, first + r))
        tau = jc.padd(ops, tau, _lanes(seg_t, first + r))
    # inclusive suffix scan of sig within each row (Hillis-Steele)
    d = 1
    while d < nt:
        act = torch.nonzero(u + d < nt).squeeze(1)
        new = jc.padd(ops, _lanes(sig, act), _lanes(sig, act + d))
        for a, v in zip(sig, new):
            a[..., act] = v
        d *= 2
    has_carry = u + 1 < nt
    run = jc.pselect(has_carry, _lanes(sig, torch.where(has_carry, lane + 1, lane)),
                     jc.identity(ops, rows * nt, dev))
    tri = jc.identity(ops, rows * nt, dev)
    for r in range(q - 1, -1, -1):
        run = jc.padd(ops, run, _lanes(seg_s, first + r))
        tri = jc.pselect(u * q + r >= 1, jc.padd(ops, tri, run), tri)

    def block_sum(v):
        d = nt // 2
        while d >= 1:
            act = torch.nonzero(u < d).squeeze(1)
            new = jc.padd(ops, _lanes(v, act), _lanes(v, act + d))
            for a, x in zip(v, new):
                a[..., act] = x
            d //= 2
        return _lanes(v, torch.arange(rows, device=dev) * nt)

    a = block_sum(tau)
    v = block_sum(tri)
    for _ in range(seg.bit_length() - 1):
        v = jc.pdbl(ops, v)
    # row w*G + g -> (G, W)
    return _rows_to_windows(jc.point_stack(jc.padd(ops, a, v)), windows, groups)


def _buckets_group(buckets, group):
    """The given group, or BN254's by the bucket sums' rank."""
    return as_group(buckets.dim() == 4) if group is None else group


def reduce_shape_n(half: int) -> tuple:
    """(s, n_seg) of K13 reduce for H = half buckets: segments of s =
    min(REDUCE_SEG_N, H) buckets, n_seg = H / s of them per row, log2(n_seg)
    tree levels above them."""
    seg = min(REDUCE_SEG_N, half)
    return seg, half // seg


def _rows_to_windows(out, windows: int, groups: int):
    """(3, coords..., rows) in row order w * G + g -> (3, coords..., G, W)."""
    shp = out.shape[:-1]
    return out.reshape(shp + (windows, groups)).transpose(-1, -2).contiguous()


def _tree_level_plain(ops, m, tri, rows: int, n: int, scale: int):
    """One level of K13's tree over n runs a row: runs a and a + 1 give T =
    (T_a + T_{a+1}) + M_{a+1} and M = 2 (M_a + M_{a+1}); at the first level
    (scale = log2 s) m holds the segments' sums S, so M_{a+1} = 2^scale
    S_{a+1} and M = 2^(1 + scale) (S_a + S_{a+1}). Returns (m, tri) of the
    n / 2 runs."""
    lo = torch.arange(rows * (n // 2), device=tri[0].device)
    lo = (lo // (n // 2)) * n + 2 * (lo % (n // 2))
    m_a, m_b = _lanes(m, lo), _lanes(m, lo + 1)
    scaled = m_b
    for _ in range(scale):
        scaled = jc.pdbl(ops, scaled)
    tri = jc.padd(ops, jc.padd(ops, _lanes(tri, lo), _lanes(tri, lo + 1)), scaled)
    m = jc.padd(ops, m_a, m_b)
    for _ in range(1 + scale):
        m = jc.pdbl(ops, m)
    return m, tri


def msm_reduce_n_plain(ops, buckets, windows: int, groups: int, half: int):
    """Plain version of K13 reduce, in its order of additions: K4's
    segments stage (S and T per segment of s buckets), then the tree
    (csrc/msm_kernels_n.cuh) halving each row's runs until one is left,
    whose T is the window sum."""
    rows = windows * groups
    seg, n_seg = reduce_shape_n(half)
    m, tri = msm_reduce_segments_plain(ops, buckets, rows, half, seg)
    n, scale = n_seg, seg.bit_length() - 1
    while n > 1:
        m, tri = _tree_level_plain(ops, m, tri, rows, n, scale)
        n, scale = n // 2, 0
    return _rows_to_windows(jc.point_stack(tri), windows, groups)


def msm_reduce_plain(buckets, windows: int, groups: int, half: int, group=None):
    """Plain version of K4 / K13 reduce: (3, coords..., W*G*H) -> (3,
    coords..., G, W)."""
    grp = _buckets_group(buckets, group)
    ops = grp.plain
    if grp.curve >= 0:
        return msm_reduce_n_plain(ops, buckets, windows, groups, half)
    seg, n_seg, nt, _q = reduce_shape(half)
    seg_s, seg_t = msm_reduce_segments_plain(ops, buckets, windows * groups, half, seg)
    return msm_reduce_rows_plain(ops, seg_s, seg_t, windows, groups, n_seg, nt, seg)


def msm_reduce(buckets, windows: int, groups: int, half: int, group=None):
    """Window sums sum_b b * bucket_b: (3, coords..., W*G*H) -> (3, coords..., G, W).
    Two launches (segments, rows) of K4 for BN254 (`group` None: G1 or G2 by
    the rank); for the other curves' groups K13, its segments stage and one
    launch per tree level (`msm_reduce_n_plain`)."""
    grp = _buckets_group(buckets, group)
    if (buckets.shape[-1] != windows * groups * half or half & (half - 1)
            or buckets.dtype != torch.int32 or tuple(buckets.shape[:-1]) != (3,) + grp.coords):
        raise ValueError("msm_reduce: inconsistent shapes")
    if REDUCE_SEG & (REDUCE_SEG - 1) or REDUCE_BLOCK & (REDUCE_BLOCK - 1) or REDUCE_BLOCK > 256:
        raise ValueError("msm_reduce: REDUCE_SEG and REDUCE_BLOCK must be powers of two, "
                         "REDUCE_BLOCK at most 256")
    if buckets.device.type == "cpu":
        return msm_reduce_plain(buckets, windows, groups, half, grp)
    if buckets.device.type != "cuda":
        raise RuntimeError(f"msm_reduce: unsupported device {buckets.device}")
    buckets = buckets.contiguous()
    if grp.curve >= 0:
        return _msm_reduce_n(buckets, windows, groups, half, grp)
    seg, n_seg, nt, _q = reduce_shape(half)
    coords = tuple(buckets.shape[1:-1])
    rows = windows * groups
    seg_s, seg_t = (torch.empty((3,) + coords + (rows * n_seg,), dtype=torch.int32,
                                device=buckets.device) for _ in range(2))
    out = torch.empty((3,) + coords + (groups, windows), dtype=torch.int32, device=buckets.device)
    for stage in (0, 1):
        args = (int(grp.g2), stage, out.data_ptr(), seg_s.data_ptr(), seg_t.data_ptr(),
                buckets.data_ptr(), windows, groups, half, seg, nt)
        if grp.curve < 0:
            kernels.MSM_REDUCE.launch(*args)
        else:
            kernels.MSM_REDUCE_N.launch(grp.curve, *args)
    return out


def k13_tree_blocks_per_sm(grp) -> int:
    """Blocks of 32 threads an SM of the card holds for K13's tree kernel at
    the slots of the group's programs (cudaOccupancyMaxActiveBlocksPer-
    Multiprocessor): what the slots leave of the card."""
    meta = (ctypes.c_int * 7)(*pprog.group_programs(grp).meta())
    return kernels.lib().snark_msm_n_occupancy(grp.curve, int(grp.g2), ctypes.addressof(meta))


def _msm_reduce_n(buckets, windows: int, groups: int, half: int, grp):
    """K13 reduce on the card: K4's segments stage, then one launch per tree
    level (`msm_reduce_n_plain`); the last level writes the window sums."""
    rows = windows * groups
    seg, n_seg = reduce_shape_n(half)
    dev = buckets.device
    gp = pprog.group_programs(grp)
    table, meta = pprog.program_table(grp, dev), (ctypes.c_int * 7)(*gp.meta())
    out = torch.empty((3,) + grp.coords + (groups, windows), dtype=torch.int32, device=dev)

    def runs(n):
        return tuple(torch.empty((3,) + grp.coords + (rows * n,), dtype=torch.int32, device=dev)
                     for _ in range(2))

    def launch(stage, m_out, t_out, m_in, t_in, n, k):
        kernels.MSM_REDUCE_N.launch(grp.curve, int(grp.g2), stage, out.data_ptr(),
                                    *(0 if t is None else t.data_ptr()
                                      for t in (m_out, t_out, m_in, t_in)),
                                    windows, groups, n, k, table.data_ptr(),
                                    ctypes.addressof(meta))

    m, t = runs(n_seg)
    launch(0, m, t, buckets, None, half, seg)
    if n_seg == 1:
        return _rows_to_windows(t, windows, groups)
    n, scale = n_seg, seg.bit_length() - 1
    while n > 1:
        m2, t2 = runs(n // 2) if n > 2 else (None, None)
        launch(1, m2, t2, m, t, n, scale)
        m, t, n, scale = m2, t2, n // 2, 0
    return out


# ---------------------------------------------------------------- K6

SUM_MAX_STACKS = 1024  # stacks one K6 launch sums (P / 2 <= 512 thread pairs a lane)


def sum_windows_plain(stacks: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: the S stacks padded with identities to a power
    of two, then level k adds element i + 2^k onto element i for i a
    multiple of 2^(k + 1) (icicle_snark_tpu/ops/msm.py _roll_reduce, the
    order of the mesh combine), jcurve.padd over the flattened lanes."""
    ops = _ops(stacks.dim() == 6, True)
    pts = [s.flatten(-2) for s in stacks.unbind(0)]
    ident = jc.point_stack(jc.identity(ops, pts[0].shape[-1], stacks.device))
    pts += [ident] * ((1 << (len(pts) - 1).bit_length()) - len(pts))
    while len(pts) > 1:
        pts = [jc.point_stack(jc.padd(ops, jc.point_unstack(a), jc.point_unstack(b)))
               for a, b in zip(pts[0::2], pts[1::2])]
    return pts[0].reshape(stacks.shape[1:])


def sum_windows(stacks: torch.Tensor) -> torch.Tensor:
    """The lane-wise sum of S stacks of window sums, (S, 3, 8, G, W) for G1
    or (S, 3, 2, 8, G, W) for G2, in the tree order of `sum_windows_plain`:
    one K6 launch for a CUDA tensor (none for S = 1). Complete projective
    additions, so identities (z = 0) pass through."""
    g2 = stacks.dim() == 6
    if (stacks.dtype != torch.int32 or stacks.dim() not in (5, 6) or stacks.shape[1] != 3
            or stacks.shape[-3] != NLIMB or (g2 and stacks.shape[2] != 2)
            or not 1 <= stacks.shape[0] <= SUM_MAX_STACKS):
        raise ValueError(f"sum_windows: want int32 (S, 3, [2,] 8, G, W), 1 <= S <= "
                         f"{SUM_MAX_STACKS}, got {tuple(stacks.shape)}")
    if stacks.shape[0] == 1:
        return stacks[0]
    if stacks.device.type == "cpu":
        return sum_windows_plain(stacks)
    if stacks.device.type != "cuda":
        raise RuntimeError(f"sum_windows: unsupported device {stacks.device}")
    stacks = stacks.contiguous()
    out = torch.empty(stacks.shape[1:], dtype=torch.int32, device=stacks.device)
    kernels.POINT_ADD.launch(int(g2), out.data_ptr(), stacks.data_ptr(), stacks.shape[0],
                             stacks.shape[-1] * stacks.shape[-2])
    return out


def acc_windows(acc: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Lane-wise complete projective add of two stacks of window sums,
    (3, 8, G, W) for G1 or (3, 2, 8, G, W) for G2 (icicle_snark_tpu/ops/
    msm.py _acc_windows): `sum_windows` at S = 2, one K6 launch."""
    if acc.shape != new.shape or acc.device != new.device:
        raise ValueError(f"acc_windows: want two stacks of one shape, got {tuple(acc.shape)}, "
                         f"{tuple(new.shape)}")
    return sum_windows(torch.stack((acc, new)))


# ---------------------------------------------------------------- K7: precompute

def precompute_bases(points, ops, c: int, factor: int):
    """Precompute-factor bases (icicle_snark_tpu/ops/msm.py
    precompute_bases): affine (x, y) with n lanes -> n * factor lanes, lane
    i * factor + m holding 2^(m * c * wp) * P_i, wp = merged_windows(c,
    factor). Each further copy is c * wp doublings (K7 point_dbl_k) of the
    last one, made affine again (K7 point_to_affine); (0, 0) stays (0, 0)."""
    if factor == 1:
        return points
    x, y = points
    shift = c * merged_windows(c, factor)
    copies = [(x, y)]
    for _ in range(factor - 1):
        ax, ay = copies[-1]
        inf = ops.is_zero_lanes(ax) & ops.is_zero_lanes(ay)
        one = ops.const((1, 0) if ops.g2 else 1, ax.shape[-1], ax.device)
        z = torch.where(inf, torch.zeros_like(one), one)
        copies.append(jc.to_affine(ops, jc.pdbl_k(ops, (ax, ay, z), shift)))
    return tuple(
        torch.stack([cp[i] for cp in copies], dim=-1).flatten(-2).contiguous() for i in range(2))


def merge_digit_windows(arr: torch.Tensor, factor: int, fill=0) -> torch.Tensor:
    """(W, n) per-window rows -> (wp, n * factor) merged rows: merged window
    j, lane i * factor + m = arr[j + m * wp, i]; the dead slots (wp * factor
    > W) hold `fill` (icicle_snark_tpu/ops/msm.py _merge_digit_windows)."""
    w, n = arr.shape
    wp = -(-w // factor)
    if wp * factor > w:
        arr = torch.cat([arr, torch.full((wp * factor - w, n), fill, dtype=arr.dtype,
                                         device=arr.device)])
    return arr.reshape(factor, wp, n).permute(1, 2, 0).reshape(wp, n * factor)


# ---------------------------------------------------------------- pipeline

SORT_MAX_BITS = 31  # key bits of one sort of every window's pairs (int32 keys)


def group_ids(sizes, dev) -> torch.Tensor:
    """(sum(sizes),) int32: the group of each lane of group-concatenated
    lanes of the given sizes, made by fills on `dev` with no blocking wait
    (no host copy, no repeat_interleave of a tensor of counts)."""
    return torch.cat([torch.full((s,), g, dtype=torch.int32, device=dev)
                      for g, s in enumerate(sizes)]
                     or [torch.empty(0, dtype=torch.int32, device=dev)])


def window_pairs_plain(scalars, base, c: int, precompute: int = 1, kr_step: int = 0):
    """Plain version of K19's first launch (`window_pairs`): the digits of
    `window_digits_signed`, merged as `merge_digit_windows` merges them."""
    digits, neg = window_digits_signed(scalars, c)
    if precompute > 1:
        digits = merge_digit_windows(digits, precompute, 0)
        neg = merge_digit_windows(neg, precompute, False)
    wp, total = digits.shape
    dev = scalars.device
    rows = torch.arange(wp, device=dev)[:, None] * kr_step
    keys = digits + base.to(torch.int64).repeat_interleave(precompute) + rows
    lanes = torch.arange(total, dtype=torch.int32, device=dev)
    return keys.to(torch.int32), torch.where(neg, lanes | -(1 << 31), lanes)  # sign: top bit


def window_pairs(scalars: torch.Tensor, base: torch.Tensor, c: int, precompute: int = 1,
                 kr_step: int = 0):
    """The (key, value) pairs of every window of an MSM pipeline, K19's
    first launch: scalars (words, n) int32 (8 or 12 words), base (n,) int32,
    each scalar lane's group * (H + 1). Returns keys and values, each
    (wp, n * precompute) int32, wp = merged_windows(c, precompute, 32
    words): for merged window j and lane l, key = j * kr_step + base +
    |digit| and value = l | neg << 31, the balanced digits of
    `window_digits_signed` in the lanes of `merge_digit_windows` (dead slots
    digit 0). The caller keeps wp * kr_step within 31 bits."""
    words, n = scalars.shape
    if (scalars.dtype != torch.int32 or base.dtype != torch.int32 or base.shape != (n,)
            or base.device != scalars.device or words not in (8, 12)):
        raise ValueError("window_pairs: want (8 or 12, n) int32 scalars and an (n,) int32 base")
    if scalars.device.type == "cpu":
        return window_pairs_plain(scalars, base, c, precompute, kr_step)
    if scalars.device.type != "cuda":
        raise RuntimeError(f"window_pairs: unsupported device {scalars.device}")
    wp = merged_windows(c, precompute, 32 * words)
    scalars, base = scalars.contiguous(), base.contiguous()
    keys, vals = (torch.empty((wp, n * precompute), dtype=torch.int32, device=scalars.device)
                  for _ in range(2))
    kernels.MSM_SORT_KEYS.launch(keys.data_ptr(), vals.data_ptr(), scalars.data_ptr(),
                                 base.data_ptr(), n, words, c, wp, precompute, kr_step)
    return keys, vals


def sort_pairs_plain(keys, vals):
    """Plain version of K19's sort: the keys as int64, torch.sort(stable=True)."""
    sorted_keys, idx = torch.sort(keys.to(torch.int64), stable=True)
    return sorted_keys.to(torch.int32), vals[idx]


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor, bits: int):
    """(n,) int32 keys in [0, 2^bits) and (n,) int32 values -> both in the
    order of a stable sort by key: K19's sort (cub's radix sort over key
    bits [0, bits), its scratch from torch's allocator, on the current
    stream). On CUDA the inputs are its double buffer and are overwritten.
    Counts `sort_items` and `sort_bits` in the open span."""
    n = keys.numel()
    if (keys.dtype != torch.int32 or vals.dtype != torch.int32 or keys.dim() != 1
            or vals.shape != keys.shape or vals.device != keys.device
            or not 1 <= bits <= SORT_MAX_BITS or n >= 1 << 31):
        raise ValueError(f"sort_pairs: want (n,) int32 keys and values, n < 2^31, and 1 <= "
                         f"bits <= {SORT_MAX_BITS}")
    trace.count("sort_items", n)
    trace.count("sort_bits", bits)
    if keys.device.type == "cpu":
        return sort_pairs_plain(keys, vals)
    if keys.device.type != "cuda":
        raise RuntimeError(f"sort_pairs: unsupported device {keys.device}")
    if n == 0:
        return keys, vals
    keys, vals = keys.contiguous(), vals.contiguous()
    need = ctypes.c_longlong()
    err = kernels.lib().snark_msm_sort_bytes(n, bits, ctypes.addressof(need))
    if err:
        raise RuntimeError(f"msm_sort: CUDA error {err} sizing the sort")
    temp = torch.empty(max(need.value, 1), dtype=torch.uint8, device=keys.device)
    keys_alt, vals_alt = torch.empty_like(keys), torch.empty_like(vals)
    selector = ctypes.c_int()
    kernels.MSM_SORT.launch(keys.data_ptr(), keys_alt.data_ptr(), vals.data_ptr(),
                            vals_alt.data_ptr(), n, bits, temp.data_ptr(), need.value,
                            ctypes.addressof(selector))
    return (keys_alt, vals_alt) if selector.value else (keys, vals)


def _sorted_pairs(scalars, gid, groups: int, c: int, precompute: int, max_bits: int):
    """Every window's pairs (`window_pairs`), sorted: (values (W, total),
    ends (W, G * (H + 1))) for `sort_windows`. One sort of all W * total
    pairs by key w * KR + group * (H + 1) + |digit|, KR = (G + 1)(H + 1),
    over the bits of W * KR where those are at most `max_bits` and W *
    total < 2^31; else each window's pairs sorted alone over the bits of KR."""
    half = 1 << (c - 1)
    kr = (groups + 1) * (half + 1)
    windows = merged_windows(c, precompute, 32 * scalars.shape[0])
    total = scalars.shape[-1] * precompute
    if total >= 1 << 31 or kr > 1 << 31:
        raise ValueError(f"sort_windows: {total} lanes and {kr} keys a window exceed 31 bits")
    dev = scalars.device
    base = gid * (half + 1)
    probes = torch.arange(groups * (half + 1), dtype=torch.int32, device=dev)
    bits = (windows * kr - 1).bit_length()
    if windows * total < 1 << 31 and bits <= max_bits:
        keys, vals = window_pairs(scalars, base, c, precompute, kr)
        keys, vals = sort_pairs(keys.view(-1), vals.view(-1), bits)
        w = torch.arange(windows, dtype=torch.int32, device=dev)[:, None]
        ends = torch.searchsorted(keys, probes + w * kr, right=True, out_int32=True) - w * total
        return vals.view(windows, total), ends
    keys, vals = window_pairs(scalars, base, c, precompute)
    rows = [sort_pairs(k, v, (kr - 1).bit_length()) for k, v in zip(keys, vals)]
    ends = torch.stack([torch.searchsorted(k, probes, right=True, out_int32=True)
                        for k, _ in rows])
    return torch.stack([v for _, v in rows]), ends


def sort_windows(scalars: torch.Tensor, groups_of, c: int, precompute: int = 1):
    """Digits, keys and the sort of every window: (order, negs, ends) for
    K4. `groups_of` is the list of group sizes, or (gids, n_groups) with a
    per-lane group id tensor; lanes whose id is n_groups sort past every
    bucket. With precompute f the rows are the merged windows over f
    times the lanes. Returns order (W, total) int32, each window's lanes
    sorted by group * (H + 1) + |digit|, ties in lane order; negs (W,
    total) bool, their digits' signs; ends (W, G * (H + 1)) int32, the
    lanes with key <= k. K19 makes and sorts the pairs (`_sorted_pairs`)."""
    if isinstance(groups_of, tuple):
        gid, groups = groups_of
        gid = gid.to(device=scalars.device, dtype=torch.int32)
    else:
        groups = len(groups_of)
        gid = group_ids(groups_of, scalars.device)
    vals, ends = _sorted_pairs(scalars, gid, groups, c, precompute, SORT_MAX_BITS)
    negs = vals < 0
    return vals.bitwise_and_(0x7FFFFFFF), negs, ends


def _window_sums(scalars, groups_of, records, c: int, precompute: int, group=None):
    groups = groups_of[1] if isinstance(groups_of, tuple) else len(groups_of)
    with trace.span("msm.sort"):
        order, negs, ends = sort_windows(scalars, groups_of, c, precompute)
    half = 1 << (c - 1)
    with trace.span("msm.accumulate"):
        buckets = msm_accumulate(records, order, negs, ends, groups, half, group)
    with trace.span("msm.reduce"):
        return msm_reduce(buckets, order.shape[0], groups, half, group)


def msm_window_sums(scalars: torch.Tensor, group_sizes, records, c: int, precompute: int = 1,
                    group=None):
    """Window sums of group-concatenated MSMs: scalars (words, total) (8 for
    BN254), records the `point_records` of the affine points concatenated in
    the same lane order (total * precompute rows in the `precompute_bases`
    layout), of BN254's G1 or G2 (`group` None) or of `group`.
    Returns stacked (3, coords..., G, wp) projective Montgomery window sums,
    wp = merged_windows(c, precompute, 32 words)."""
    if (scalars.shape[-1] != sum(group_sizes)
            or records.shape[0] != scalars.shape[-1] * precompute):
        raise ValueError("msm_window_sums: scalar and point lanes differ")
    return _window_sums(scalars, list(group_sizes), records, c, precompute, group)


def msm_windows_sliced(scalars: torch.Tensor, group_sizes, records, c: int, max_lanes: int,
                       precompute: int = 1):
    """Out-of-core window sums (icicle_snark_tpu/ops/msm.py
    msm_windows_sliced): the concatenated lanes are cut into slices of
    max_lanes // precompute scalars (group boundaries may fall inside a
    slice; per-lane group ids keep the buckets apart), every slice runs
    the in-core pipeline, and one K6 launch sums the slices' window sums
    (`sum_windows`, in its tree order). The last slice is padded to the
    slice width with lanes of the sentinel group len(group_sizes), zero
    scalars and (0, 0) points, so every slice has one shape. records as for
    `msm_window_sums`. Returns stacked (3, coords..., G, wp)."""
    total = sum(group_sizes)
    if scalars.shape[-1] != total or records.shape[0] != total * precompute:
        raise ValueError("msm_windows_sliced: scalar and point lanes differ")
    width = max_lanes // precompute
    if width < 1:
        raise ValueError(f"msm_windows_sliced: max_lanes {max_lanes} below the factor {precompute}")
    groups = len(group_sizes)
    dev = scalars.device
    gid = group_ids(group_sizes, dev)
    parts = []
    for lo in range(0, max(total, 1), width):
        hi = min(lo + width, total)
        sc, ids = scalars[:, lo:hi], gid[lo:hi]
        rec = records[precompute * lo: precompute * hi]
        pad = width - (hi - lo)
        if pad:
            sc = torch.cat([sc, sc.new_zeros((NLIMB, pad))], dim=-1)
            ids = torch.cat([ids, ids.new_full((pad,), groups)])
            rec = torch.cat([rec, rec.new_zeros((pad * precompute, rec.shape[1]))])
        parts.append(_window_sums(sc, (ids, groups), rec, c, precompute))
    return sum_windows(torch.stack(parts))


def window_sums(scalars: torch.Tensor, group_sizes, records, c: int, precompute: int = 1,
                max_lanes: int | None = None):
    """BN254 window sums, in core (`msm_window_sums`) up to the cap on
    point lanes and sliced (`msm_windows_sliced`) past it: the cap is
    `max_lanes`, else MSM_MAX_LANES (read at the call), halved for G2's
    records (32 words a record, twice G1's bytes). Arguments and result as
    for `msm_window_sums`."""
    cap = max_lanes or MSM_MAX_LANES
    if records.shape[-1] == 2 * BN254_G2.words:
        cap = max(cap // 2, 1)
    if scalars.shape[-1] * precompute > cap:
        return msm_windows_sliced(scalars, group_sizes, records, c, cap, precompute)
    return msm_window_sums(scalars, group_sizes, records, c, precompute)


# ---------------------------------------------------------------- host side

class HostCopy:
    """A tensor's copy to the host, started when made and waited for by
    `wait`. On CUDA: a non-blocking copy into page-locked memory (torch's
    caching host allocator) on the current stream, with an event recorded
    behind it, so `wait` blocks on the copy and what was queued before it,
    not on work queued later. On the CPU the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def wait(self) -> np.ndarray:
        """The copy as a numpy array, once it has landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _col_ints(arr: np.ndarray) -> list:
    """(8, k) uint32 Montgomery limbs -> k standard-form Fq ints."""
    raw = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32).T).astype("<u4").tobytes()
    return [fq_from_mont(int.from_bytes(raw[32 * i: 32 * (i + 1)], "little"))
            for i in range(len(raw) // 32)]


def window_points_to_host_g1(wsums, g: int = 0) -> list:
    """wsums (3, 8, G, W) (tensor or numpy) -> W host projective points."""
    arr = _np_u32(wsums)
    xs, ys, zs = (_col_ints(arr[i][:, g, :]) for i in range(3))
    return list(zip(xs, ys, zs))


def window_points_to_host_g2(wsums, g: int = 0) -> list:
    """wsums (3, 2, 8, G, W) -> W host projective G2 points."""
    arr = _np_u32(wsums)
    c = [[_col_ints(arr[i][comp][:, g, :]) for comp in range(2)] for i in range(3)]
    return [
        tuple((c[i][0][w], c[i][1][w]) for i in range(3))
        for w in range(arr.shape[-1])
    ]


def _np_u32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).view(np.uint32)


def horner_combine(window_points, c: int, g2: bool = False):
    """result = sum_w 2^(c*w) * W_w via doubling-Horner (host, exact)."""
    if g2:
        dbl, add, zero = rcv.g2_dbl, rcv.g2_add, rcv.G2_ZERO
    else:
        dbl, add, zero = rcv.g1_dbl, rcv.g1_add, rcv.G1_ZERO
    acc = zero
    for p in reversed(window_points):
        for _ in range(c):
            acc = dbl(acc)
        acc = add(acc, p)
    return acc


def host_points(wsums: np.ndarray, c: int, groups: int, g2: bool) -> list:
    """Window sums already on the host, (3, coords..., G, W), -> the first
    `groups` groups' host projective points (Horner on the host)."""
    to_host = window_points_to_host_g2 if g2 else window_points_to_host_g1
    return [horner_combine(to_host(wsums, g), c, g2=g2) for g in range(groups)]


# ---------------------------------------------------------------- the op surface

def _check_scalars(scalars: torch.Tensor):
    """Signed digits need scalars below 2^254 (window_digits_signed)."""
    if scalars.dtype != torch.int32 or scalars.dim() != 2 or scalars.shape[0] != NLIMB:
        raise InvalidArgument(f"msm: want (8, n) int32 scalars, got {tuple(scalars.shape)}")
    if bool(((scalars[NLIMB - 1].to(torch.int64) & 0xFFFFFFFF) >> 30).any()):
        raise InvalidArgument("msm: scalars must lie below 2^254")


def _msm(groups, c, g2: bool, pre: int):
    for s, _ in groups:
        _check_scalars(s)
    sizes = [s.shape[-1] for s, _ in groups]
    scalars = torch.cat([s for s, _ in groups], dim=-1)
    records = point_records(tuple(torch.cat([p[i] for _, p in groups], dim=-1) for i in range(2)))
    if records.shape[0] != scalars.shape[-1] * pre:
        raise InvalidArgument(f"msm: {records.shape[0]} points for {scalars.shape[-1]} scalars "
                              f"and precompute factor {pre}")
    ws = window_sums(scalars, sizes, records, c, pre)
    return host_points(ws.cpu().numpy(), c, len(groups), g2)


def _cfg_params(cfg, c, k):
    """Merge an MSMConfig with direct keyword overrides (as
    icicle_snark_tpu/ops/msm.py _cfg_params). Returns (c, k,
    precompute_factor); k, the JAX package's prefix-scan chunk, has no
    counterpart in the port and is returned only for parity."""
    if cfg is None:
        return c, k, 1
    return (c or (cfg.c or None)), (cfg.chunk if k == 32 else k), cfg.precompute_factor


def msm_g1_many(groups, c: int | None = None, k: int = 32) -> list:
    """Batched G1 MSMs through one pipeline: groups = [(scalars (8, n_i)
    int32, integers below 2^254; (x, y) each (8, n_i) Montgomery affine,
    (0, 0) the identity), ...]. Returns a list of host projective points
    (ints, standard form). Past MSM_MAX_LANES lanes the sliced route (K6)
    runs. Device work: K4 accumulate and reduce."""
    total = sum(s.shape[-1] for s, _ in groups)
    c = c or choose_c(min(total, MSM_MAX_LANES), groups=len(groups))
    return _msm(groups, c, False, 1)


def msm_g1(scalars, points_affine, c: int | None = None, k: int = 32, cfg=None):
    """Single G1 MSM. scalars (8, n) int32 integers below 2^254; points
    (x, y) each (8, n) Montgomery affine, or (8, n * f) as `precompute_bases`
    returns them for cfg.precompute_factor f > 1 (made with the same c).
    Returns a host projective point (ints, standard form)."""
    c, k, pre = _cfg_params(cfg, c, k)
    c = c or choose_c(min(scalars.shape[-1], MSM_MAX_LANES // pre), factor=pre)
    return _msm([(scalars, points_affine)], c, False, pre)[0]


def msm_g2(scalars, points_affine, c: int | None = None, k: int = 32, cfg=None):
    """Single G2 MSM: points (x, y) each (2, 8, n) (or (2, 8, n * f)
    precomputed). The in-core pipeline takes half the G1 lanes, as in the
    JAX package; past that the sliced route runs."""
    c, k, pre = _cfg_params(cfg, c, k)
    c = c or choose_c(min(scalars.shape[-1], MSM_MAX_LANES // 2 // pre), factor=pre)
    return _msm([(scalars, points_affine)], c, True, pre)[0]
