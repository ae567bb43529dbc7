"""Pippenger multi-scalar multiplication (kernels K4, K6, K7).

The bucket method as the reference runs it on a GPU, over the data layout
of icicle_snark_tpu/ops/msm.py:

  1. signed c-bit window digits of the scalars (plain torch, msm.py:167);
  2. per window, lanes sorted by key = group * (H + 1) + |digit| with
     torch.sort, H = 2^(c-1), and bucket ends by searchsorted;
  3. `msm_accumulate` (K4): one thread per (window, group, bucket) adds the
     affine points of its run, y negated for negative digits;
  4. `msm_reduce` (K4): sum_b b * bucket_b per (window, group);
  5. Horner over the windows on the host (Python ints).

All G1 MSMs of a prove run as ONE pipeline over group-concatenated lanes
(the batched mode of the JAX package); the window sums come back stacked
(3, coords..., G, W) in Montgomery form, G1 coords (8,), G2 (2, 8).
Scalars are raw integers (8, n) int32 (the witness and h values).

Two variants of the JAX package's large-circuit path ride on the same
kernels:
  * sliced (`msm_windows_sliced`): past `MSM_MAX_LANES` point lanes the
    concatenated lanes are cut into fixed-width slices, each slice runs
    steps 1-4 with per-lane group ids, and `acc_windows` (K6) adds the
    slices' window sums in slice order;
  * precomputed bases (`precompute_bases`, K7): with factor f the key holds
    f affine copies 2^(c*wp*m) * P of every base, interleaved at lane
    i*f + m, and the W = ceil(256/c) digit windows merge into
    wp = ceil(W/f) windows over f times the lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..curve import jcurve as jc
from ..fields.limbs import NLIMB
from ..refmath import curve as rcv
from ..refmath.field import fq_from_mont

SCALAR_BITS = 256
# buckets per thread in the first reduce pass (K4 reduce)
REDUCE_SEG = 32


# Point lanes one in-core MSM pipeline may hold. Per point lane the
# pipeline keeps, for each of W windows: the digit and its key (2 x int64),
# torch.sort's sorted keys and order (2 x int64), the int32 order K4 reads,
# and three sign bytes: 39 bytes, 624 per lane at W = 16 (c = 16) and 780
# at W = 20 (c = 13), plus the affine point (64 bytes G1, 128 G2): 1 KiB
# per lane covers both. 2^25 lanes are then 32 GiB of an 80 GB card, which
# leaves room for the proving key, the NTT batch and the allocator's slack.
# The G2 MSM takes half the lanes, as in the JAX package.
MSM_MAX_LANES = 1 << 25
# Precompute factor of the default plan (G1, G2). Measured on an H100
# (PERF.md), factor 2 took 3 to 7 % off the window sums at the same
# window size, and 5 % off a complex-1600k prove, for twice the resident
# bases and a longer cache build: the default stays 1.
MSM_PRE_DEFAULT = (1, 1)


def merged_windows(c: int, factor: int = 1) -> int:
    """Windows left after merging: wp = ceil(ceil(256 / c) / factor)."""
    return -(-(-(-SCALAR_BITS // c)) // factor)


# BN254 scalars are below the 254-bit group order r.
SCALAR_DATA_BITS = 254
# What one serial point addition costs in units of the card's aggregate time
# per addition: K4 walks a bucket's run, and sums the reduce's segments, in
# ONE thread. Measured on an H100 (PERF.md): a lone thread's G1 add
# takes about 12 us against 0.8 ns per add with the card full, G2 82 us
# against 8.5 ns: 2^13 to 2^14.
SERIAL_WEIGHT = 1 << 13


def choose_c(n: int, groups: int = 1, factor: int = 1) -> int:
    """Window size that minimises K4's modelled time, in point additions
    (c in 8..16; signed digits need c >= 8): wp merged windows, each with
    one mixed add per point lane (n * factor, dead slots included) and two
    adds per bucket in the reduce, all spread over the card; plus the two
    chains that run in a single thread, weighted by SERIAL_WEIGHT: the
    longest bucket run and the reduce's final pass over H / REDUCE_SEG
    segment sums. The longest run is the top window's: the window that
    holds bit 253 has only 254 - c * floor(253 / c) data bits, so its
    lanes crowd into 2^bits buckets (c = 13: 128 buckets, c = 14: 4,
    c = 15 and 16: 2^14)."""
    best_c, best_cost = 8, None
    for c in range(8, 17):
        half = 1 << (c - 1)
        top_bits = SCALAR_DATA_BITS - ((SCALAR_DATA_BITS - 1) // c) * c
        longest_run = n / groups / min(half, 1 << top_bits)
        cost = (merged_windows(c, factor) * (n * factor + 2 * groups * half)
                + SERIAL_WEIGHT * (longest_run + half / REDUCE_SEG))
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
    """(8, n) int32 scalars -> (abs (W, n) int64 in [0, 2^(c-1)], neg (W, n)
    bool): balanced digits, the carry moving into the next window. Scalars
    below 2^254 never carry out of the top window for c >= 8."""
    s = scalars.to(torch.int64) & 0xFFFFFFFF
    n_windows = -(-SCALAR_BITS // c)
    mask, half, full = (1 << c) - 1, 1 << (c - 1), 1 << c
    carry = torch.zeros_like(s[0])
    outs_abs, outs_neg = [], []
    for w in range(n_windows):
        word, off = divmod(w * c, 32)
        d = (s[word] >> off) if word < NLIMB else torch.zeros_like(carry)
        if off + c > 32 and word + 1 < NLIMB:
            d = d | (s[word + 1] << (32 - off))
        d = (d & mask) + carry
        neg = d > half
        carry = neg.to(torch.int64)
        outs_abs.append(torch.where(neg, full - d, d))
        outs_neg.append(neg)
    return torch.stack(outs_abs), torch.stack(outs_neg)


def _ops(g2: bool, plain: bool):
    if g2:
        return jc.G2_PLAIN if plain else jc.G2
    return jc.G1_PLAIN if plain else jc.G1


# ---------------------------------------------------------------- K4: accumulate

def msm_accumulate_plain(px, py, order, negs, ends, groups: int, half: int):
    """Plain version of K4 accumulate: bucket sums, (3, coords..., W*G*H)."""
    g2 = px.dim() == 3
    ops = _ops(g2, True)
    windows = order.shape[0]
    nbk = windows * groups * half
    dev = px.device
    t = torch.arange(nbk, device=dev)
    w = t // (groups * half)
    rem = t % (groups * half)
    key = (rem // half) * (half + 1) + rem % half + 1
    ends64 = ends.to(torch.int64)
    lo = ends64[w, key - 1]
    cnt = ends64[w, key] - lo
    acc = list(jc.identity(ops, nbk, dev))
    for r in range(int(cnt.max()) if nbk else 0):
        act = torch.nonzero(cnt > r).squeeze(1)
        pos = lo[act] + r
        wa = w[act]
        lane = order[wa, pos].to(torch.int64)
        x, y = px[..., lane], py[..., lane]
        y = torch.where(negs[wa, pos], ops.neg(y), y)
        new = jc.pmadd(ops, tuple(a[..., act] for a in acc), (x, y))
        for i in range(3):
            acc[i][..., act] = new[i]
    return jc.point_stack(tuple(acc))


def msm_accumulate(px, py, order, negs, ends, groups: int, half: int):
    """Bucket sums of one MSM pipeline (all windows and groups).

    px, py: affine coordinates (8, total) for G1 or (2, 8, total) for G2;
    order: (W, total) int32 lane order of each window sorted by key;
    negs: (W, total) bool digit signs in that order;
    ends: (W, G*(H+1)) int32, lanes with key <= k.
    Returns (3, coords..., W*G*H) projective bucket sums (bucket b at b-1)."""
    g2 = px.dim() == 3
    windows, total = order.shape
    if (px.shape != py.shape or px.shape[-1] != total or px.shape[-2] != NLIMB
            or ends.shape != (windows, groups * (half + 1)) or negs.shape != order.shape):
        raise ValueError("msm_accumulate: inconsistent shapes")
    if px.device.type == "cpu":
        return msm_accumulate_plain(px, py, order, negs, ends, groups, half)
    if px.device.type != "cuda":
        raise RuntimeError(f"msm_accumulate: unsupported device {px.device}")
    px, py = px.contiguous(), py.contiguous()
    order = order.to(torch.int32).contiguous()
    negs = negs.to(torch.bool).contiguous()
    ends = ends.to(torch.int32).contiguous()
    nbk = windows * groups * half
    out = torch.empty((3,) + tuple(px.shape[:-1]) + (nbk,), dtype=torch.int32, device=px.device)
    kernels.MSM_ACCUMULATE.launch(
        int(g2), out.data_ptr(), px.data_ptr(), py.data_ptr(), order.data_ptr(),
        negs.data_ptr(), ends.data_ptr(), total, windows, groups, half,
    )
    return out


# ---------------------------------------------------------------- K4: reduce

def _reduce_seg(half: int) -> int:
    return min(REDUCE_SEG, half)


def msm_reduce_plain(buckets, windows: int, groups: int, half: int):
    """Plain version of K4 reduce: (3, coords..., W*G*H) -> (3, coords..., G, W)."""
    g2 = buckets.dim() == 4
    ops = _ops(g2, True)
    dev = buckets.device
    wg = windows * groups
    seg = _reduce_seg(half)
    n_seg = half // seg
    nbits = half.bit_length() - 1
    lanes = torch.arange(wg * n_seg, device=dev)
    row, s = lanes // n_seg, lanes % n_seg
    lo = s * seg + 1
    run = jc.identity(ops, wg * n_seg, dev)
    tri = run
    for i in range(seg):
        idx = row * half + (lo + seg - 1 - i) - 1
        bk = tuple(a[..., idx] for a in jc.point_unstack(buckets))
        run = jc.padd(ops, run, bk)
        tri = jc.padd(ops, tri, run)
    k = lo - 1
    acc = jc.identity(ops, wg * n_seg, dev)
    for bit in range(nbits - 1, -1, -1):
        acc = jc.pdbl(ops, acc)
        acc = jc.pselect(((k >> bit) & 1) == 1, jc.padd(ops, acc, run), acc)
    part = jc.padd(ops, tri, acc)
    rows = torch.arange(wg, device=dev)
    out = jc.identity(ops, wg, dev)
    for si in range(n_seg):
        out = jc.padd(ops, out, tuple(a[..., rows * n_seg + si] for a in part))
    # lane w*G + g -> (G, W)
    stacked = jc.point_stack(out)
    shp = stacked.shape[:-1]
    return stacked.reshape(shp + (windows, groups)).transpose(-1, -2).contiguous()


def msm_reduce(buckets, windows: int, groups: int, half: int):
    """Window sums sum_b b * bucket_b: (3, coords..., W*G*H) -> (3, coords..., G, W)."""
    g2 = buckets.dim() == 4
    if buckets.shape[-1] != windows * groups * half or half & (half - 1):
        raise ValueError("msm_reduce: inconsistent shapes")
    if buckets.device.type == "cpu":
        return msm_reduce_plain(buckets, windows, groups, half)
    if buckets.device.type != "cuda":
        raise RuntimeError(f"msm_reduce: unsupported device {buckets.device}")
    buckets = buckets.contiguous()
    seg = _reduce_seg(half)
    coords = tuple(buckets.shape[1:-1])
    partial = torch.empty((3,) + coords + (windows * groups * (half // seg),),
                          dtype=torch.int32, device=buckets.device)
    out = torch.empty((3,) + coords + (groups, windows), dtype=torch.int32,
                      device=buckets.device)
    kernels.MSM_REDUCE.launch(
        int(g2), out.data_ptr(), partial.data_ptr(), buckets.data_ptr(),
        windows, groups, half, seg, half.bit_length() - 1,
    )
    return out


# ---------------------------------------------------------------- K6

def acc_windows_plain(acc: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: jcurve.padd over the flattened (G, W) lanes."""
    g2 = acc.dim() == 5
    ops = _ops(g2, True)
    a, b = acc.flatten(-2), new.flatten(-2)
    out = jc.point_stack(jc.padd(ops, jc.point_unstack(a), jc.point_unstack(b)))
    return out.reshape(acc.shape)


def acc_windows(acc: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Lane-wise complete projective add of two stacks of window sums,
    (3, 8, G, W) for G1 or (3, 2, 8, G, W) for G2 (icicle_snark_tpu/ops/
    msm.py _acc_windows). Identities (z = 0) on either side pass through."""
    g2 = acc.dim() == 5
    if (acc.shape != new.shape or acc.dtype != torch.int32 or new.dtype != torch.int32
            or acc.dim() not in (4, 5) or acc.shape[0] != 3 or acc.shape[-3] != NLIMB
            or acc.device != new.device):
        raise ValueError(
            f"acc_windows: want two int32 (3, [2,] 8, G, W), got {tuple(acc.shape)}, "
            f"{tuple(new.shape)}")
    if acc.device.type == "cpu":
        return acc_windows_plain(acc, new)
    if acc.device.type != "cuda":
        raise RuntimeError(f"acc_windows: unsupported device {acc.device}")
    acc, new = acc.contiguous(), new.contiguous()
    out = torch.empty_like(acc)
    kernels.POINT_ADD.launch(int(g2), out.data_ptr(), acc.data_ptr(), new.data_ptr(),
                             acc.shape[-1] * acc.shape[-2])
    return out


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

def sort_windows(scalars: torch.Tensor, groups_of, c: int, precompute: int = 1):
    """Digits, keys and the per-window sort: (order, negs, ends) for K4.
    `groups_of` is the list of group sizes, or (gids, n_groups) with a
    per-lane group id tensor; lanes whose id is n_groups sort past every
    bucket. With precompute f the rows are the merged windows over f
    times the lanes."""
    half = 1 << (c - 1)
    dev = scalars.device
    if isinstance(groups_of, tuple):
        gid, groups = groups_of
        gid = gid.to(device=dev, dtype=torch.int64)
    else:
        groups = len(groups_of)
        gid = torch.repeat_interleave(
            torch.arange(groups, device=dev), torch.tensor(list(groups_of), device=dev))
    digits, neg = window_digits_signed(scalars, c)
    if precompute > 1:
        digits = merge_digit_windows(digits, precompute, 0)
        neg = merge_digit_windows(neg, precompute, False)
        gid = torch.repeat_interleave(gid, precompute)
    keys = gid * (half + 1) + digits  # (W, total)
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    negs = torch.gather(neg, 1, order)
    probes = torch.arange(groups * (half + 1), device=dev).expand(keys.shape[0], -1)
    ends = torch.searchsorted(sorted_keys, probes.contiguous(), right=True)
    return order.to(torch.int32), negs, ends.to(torch.int32)


def _window_sums(scalars, groups_of, points, c: int, precompute: int):
    groups = groups_of[1] if isinstance(groups_of, tuple) else len(groups_of)
    order, negs, ends = sort_windows(scalars, groups_of, c, precompute)
    half = 1 << (c - 1)
    buckets = msm_accumulate(points[0], points[1], order, negs, ends, groups, half)
    return msm_reduce(buckets, order.shape[0], groups, half)


def msm_window_sums(scalars: torch.Tensor, group_sizes, points, c: int, precompute: int = 1):
    """Window sums of group-concatenated MSMs: scalars (8, total), points
    affine (x, y) concatenated in the same lane order (total * precompute
    lanes in the `precompute_bases` layout). Returns stacked
    (3, coords..., G, wp) projective Montgomery window sums."""
    if (scalars.shape[-1] != sum(group_sizes)
            or points[0].shape[-1] != scalars.shape[-1] * precompute):
        raise ValueError("msm_window_sums: scalar and point lanes differ")
    return _window_sums(scalars, list(group_sizes), points, c, precompute)


def msm_windows_sliced(scalars: torch.Tensor, group_sizes, points, c: int, max_lanes: int,
                       precompute: int = 1):
    """Out-of-core window sums (icicle_snark_tpu/ops/msm.py
    msm_windows_sliced): the concatenated lanes are cut into slices of
    max_lanes // precompute scalars (group boundaries may fall inside a
    slice; per-lane group ids keep the buckets apart), every slice runs
    the in-core pipeline, and K6 adds the slices' window sums in slice
    order. The last slice is padded to the slice width with lanes of the
    sentinel group len(group_sizes), zero scalars and (0, 0) points, so
    every slice has one shape. Returns stacked (3, coords..., G, wp)."""
    total = sum(group_sizes)
    if scalars.shape[-1] != total or points[0].shape[-1] != total * precompute:
        raise ValueError("msm_windows_sliced: scalar and point lanes differ")
    width = max_lanes // precompute
    if width < 1:
        raise ValueError(f"msm_windows_sliced: max_lanes {max_lanes} below the factor {precompute}")
    groups = len(group_sizes)
    dev = scalars.device
    gid = torch.repeat_interleave(
        torch.arange(groups, device=dev), torch.tensor(list(group_sizes), device=dev))
    acc = None
    for lo in range(0, max(total, 1), width):
        hi = min(lo + width, total)
        sc, ids = scalars[:, lo:hi], gid[lo:hi]
        pts = tuple(p[..., precompute * lo: precompute * hi] for p in points)
        pad = width - (hi - lo)
        if pad:
            sc = torch.cat([sc, sc.new_zeros((NLIMB, pad))], dim=-1)
            ids = torch.cat([ids, ids.new_full((pad,), groups)])
            pts = tuple(torch.cat([p, p.new_zeros(p.shape[:-1] + (pad * precompute,))], dim=-1)
                        for p in pts)
        ws = _window_sums(sc, (ids, groups), pts, c, precompute)
        acc = ws if acc is None else acc_windows(acc, ws)
    return acc


# ---------------------------------------------------------------- host side

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

