"""Pippenger multi-scalar multiplication (kernel K4).

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


def choose_c(n: int, groups: int = 1) -> int:
    """Window size that minimises the point additions of the bucket method:
    ceil(256/c) windows, each costing one mixed add per lane plus two adds
    per bucket in the reduce (c in 8..16; signed digits need c >= 8)."""
    best_c, best_cost = 8, None
    for c in range(8, 17):
        windows = -(-SCALAR_BITS // c)
        cost = windows * (n + 2 * groups * (1 << (c - 1)))
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


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


# ---------------------------------------------------------------- pipeline

def sort_windows(scalars: torch.Tensor, group_sizes, c: int):
    """Digits, keys and the per-window sort: (order, negs, ends) for K4."""
    half = 1 << (c - 1)
    groups = len(group_sizes)
    dev = scalars.device
    digits, neg = window_digits_signed(scalars, c)
    gid = torch.repeat_interleave(
        torch.arange(groups, device=dev), torch.tensor(list(group_sizes), device=dev))
    keys = gid * (half + 1) + digits  # (W, total)
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    negs = torch.gather(neg, 1, order)
    probes = torch.arange(groups * (half + 1), device=dev).expand(keys.shape[0], -1)
    ends = torch.searchsorted(sorted_keys, probes.contiguous(), right=True)
    return order.to(torch.int32), negs, ends.to(torch.int32)


def msm_window_sums(scalars: torch.Tensor, group_sizes, points, c: int):
    """Window sums of group-concatenated MSMs: scalars (8, total), points
    affine (x, y) concatenated in the same lane order. Returns stacked
    (3, coords..., G, W) projective Montgomery window sums."""
    if scalars.shape[-1] != sum(group_sizes) or points[0].shape[-1] != scalars.shape[-1]:
        raise ValueError("msm_window_sums: scalar and point lanes differ")
    order, negs, ends = sort_windows(scalars, group_sizes, c)
    half = 1 << (c - 1)
    buckets = msm_accumulate(points[0], points[1], order, negs, ends, len(group_sizes), half)
    return msm_reduce(buckets, order.shape[0], len(group_sizes), half)


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

