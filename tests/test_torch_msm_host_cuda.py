"""K4's BN254 kernels run on the host: the accumulate (`msm_accumulate_kernel`,
level 0 and the fold levels, G1 and G2) and the reduce's segments stage
(`msm_reduce_segments_kernel`) of csrc/msm_kernels.cuh, in the lazy layer
(csrc/fq_lazy.cuh, csrc/fq2_lazy.cuh). A small program includes the header
and is compiled by g++ against a stub `cuda_runtime.h` that defines the CUDA
qualifiers away (the header's launches and rows stage are for nvcc only),
and calls each kernel as a function for every item and thread, one thread a
block. Held word for word against the
plain versions (ops/msm.py msm_bucket_sums_plain, msm_reduce_segments_plain)
on points of the curve: hand-made tables with (0, 0) records (as a piece's
first lane too), negated digits, pieces of length 0, 1 and L, pieces and
folds whose sum is the identity, and a doubling through the add; then the
levels of `bucket_fold_plan` and the segments stage over a grouped MSM of
bit-valued and uniform scalars, with empty buckets and identity partial
sums. Skips where no g++ is installed."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import Q, R_MOD, fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "icicle_snark_tpu_torch" / "csrc"

STUB = """#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
struct uint4 { unsigned x, y, z, w; };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline dim3 blockIdx, threadIdx, blockDim{1, 1, 1};
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __syncthreads() {}  // K11's loop in fq_lazy.cuh; not called here
"""

# acc <g2> <affine> <dir> <n_src> <n_items>: dir/{src,order,negs,start,len}.bin
#   -> dir/out.bin, every item of one accumulate level
# seg <g2> <dir> <rows> <half> <seg>: dir/buckets.bin -> dir/out.bin, S then T
# fq2 0 <dir>: dir/in.bin, (a, b) pairs of Fq2 values -> dir/out.bin, a b,
#   a + b, a - b and a b3 a pair
PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#include "msm_kernels.cuh"

template <class T> static std::vector<T> rd(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<T> v(n / sizeof(T) + 1);
  if (n && fread(v.data(), 1, n, f) != (size_t)n) exit(3);
  fclose(f);
  return v;
}

static void wr(const std::string& path, const std::vector<u32>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

template <class E, bool AFF> static void acc(const std::string& d, long long n_src, long long n) {
  std::vector<u32> src = rd<u32>(d + "/src.bin");
  std::vector<int> order = rd<int>(d + "/order.bin"), len = rd<int>(d + "/len.bin");
  std::vector<unsigned char> negs = rd<unsigned char>(d + "/negs.bin");
  std::vector<long long> start = rd<long long>(d + "/start.bin");
  std::vector<u32> out(3 * ECoord<E>::WORDS * n, 0xdeadbeefu);
  for (blockIdx.x = 0; blockIdx.x < n; blockIdx.x++)
    msm_accumulate_kernel<E, AFF>(out.data(), src.data(), n_src, order.data(), negs.data(),
                                  start.data(), len.data(), n);
  wr(d + "/out.bin", out);
}

template <class E> static void seg(const std::string& d, long long rows, long long half,
                                   long long s) {
  std::vector<u32> b = rd<u32>(d + "/buckets.bin");
  long long ns = rows * (half / s);
  std::vector<u32> sums(3 * ECoord<E>::WORDS * ns, 0xdeadbeefu), tris(sums);
  for (blockIdx.x = 0; blockIdx.x < ns; blockIdx.x++)
    msm_reduce_segments_kernel<E>(sums.data(), tris.data(), b.data(), rows, half, s);
  sums.insert(sums.end(), tris.begin(), tris.end());
  wr(d + "/out.bin", sums);
}

static void fq2(const std::string& d) {
  std::vector<u32> in = rd<u32>(d + "/in.bin"), out;
  for (size_t p = 0; p + 32 <= in.size(); p += 32) {
    E2 a, b;
    for (int k = 0; k < 8; k++) {
      a.c0.v[k] = in[p + k]; a.c1.v[k] = in[p + 8 + k];
      b.c0.v[k] = in[p + 16 + k]; b.c1.v[k] = in[p + 24 + k];
    }
    E2 r[4] = {lz_mul(a, b), lz_add(a, b), lz_sub(a, b), lz_mul_b3(a)};
    for (auto& x : r) {
      out.insert(out.end(), x.c0.v, x.c0.v + 8);
      out.insert(out.end(), x.c1.v, x.c1.v + 8);
    }
  }
  wr(d + "/out.bin", out);
}

int main(int argc, char** argv) {
  std::string mode = argv[1], d = argv[3];
  bool g2 = atoi(argv[2]);
  if (mode == "fq2") {
    fq2(d);
    return 0;
  }
  if (mode == "seg") {
    long long rows = atoll(argv[4]), half = atoll(argv[5]), s = atoll(argv[6]);
    if (g2) seg<E2>(d, rows, half, s); else seg<E1>(d, rows, half, s);
    return 0;
  }
  bool aff = atoi(argv[4]);
  long long n_src = atoll(argv[5]), n = atoll(argv[6]);
  if (g2 && aff) acc<E2, true>(d, n_src, n);
  else if (g2) acc<E2, false>(d, n_src, n);
  else if (aff) acc<E1, true>(d, n_src, n);
  else acc<E1, false>(d, n_src, n);
}
"""

C = 8
L = 4  # BUCKET_PIECE of these cases


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the header on the host")
    d = tmp_path_factory.mktemp("msm_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "msm.cpp").write_text(PROGRAM)
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", f"-I{d}", f"-I{CSRC}", str(d / "msm.cpp"),
                    "-o", str(d / "msm")], check=True, capture_output=True, timeout=600)

    def run(*args):
        subprocess.run([str(d / "msm"), *map(str, args)], check=True, capture_output=True,
                       timeout=600)
        return torch.from_numpy(np.fromfile(d / "out.bin", dtype=np.uint32).view(np.int32))

    return d, run


def _ints(words) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(words))


def test_fq2_ops_against_integers(harness):
    """The header's Fq2 product, sum, difference and b3 product on operands
    in [0, 2q), 2q - 1 and q among them: every component below 2q and the
    residue of the integer formula."""
    d, run = harness
    prng = np.random.default_rng(41)
    edges = [0, 1, Q - 1, Q, 2 * Q - 2, 2 * Q - 1]
    vals = [(a, b) for a in edges for b in edges]
    vals += [tuple(int.from_bytes(prng.bytes(32), "little") % (2 * Q) for _ in range(2))
             for _ in range(40)]
    pairs = [(a, b) for a in vals for b in vals[::7]]
    words = [[(v >> (32 * k)) & 0xFFFFFFFF for v in (*a, *b) for k in range(8)]
             for a, b in pairs]
    np.array(words, dtype=np.uint32).tofile(d / "in.bin")
    out = run("fq2", 0, d).numpy().view(np.uint32).reshape(len(pairs), 4, 2, 8)
    rinv = pow(1 << 256, -1, Q)
    b3 = (fq_to_mont(3 * cv.B_G2[0] % Q), fq_to_mont(3 * cv.B_G2[1] % Q))
    for (a, b), got in zip(pairs, out):
        mul, add, sub, mul_b3 = ([_ints(c) for c in comp] for comp in got)
        assert all(v < 2 * Q for v in mul + add + sub + mul_b3)
        for v, want in zip(mul, ((a[0] * b[0] - a[1] * b[1]) * rinv,
                                 (a[0] * b[1] + a[1] * b[0]) * rinv)):
            assert v % Q == want % Q
        assert [v % Q for v in add] == [(x + y) % Q for x, y in zip(a, b)]
        assert [v % Q for v in sub] == [(x - y) % Q for x, y in zip(a, b)]
        for v, want in zip(mul_b3, ((a[0] * b3[0] - a[1] * b3[1]) * rinv,
                                    (a[0] * b3[1] + a[1] * b3[0]) * rinv)):
            assert v % Q == want % Q


def _host_level(harness, g2, affine, src, order, negs, start, length):
    """One accumulate level on the host, as msm_bucket_sums_plain's output."""
    d, run = harness
    src.contiguous().numpy().tofile(d / "src.bin")
    order.to(torch.int32).numpy().tofile(d / "order.bin")
    negs.to(torch.uint8).numpy().tofile(d / "negs.bin")
    start.to(torch.int64).numpy().tofile(d / "start.bin")
    length.to(torch.int32).numpy().tofile(d / "len.bin")
    n_src = src.shape[0] if affine else src.shape[-1]
    out = run("acc", int(g2), d, int(affine), n_src, start.shape[0])
    return out.reshape((3,) + msm.as_group(g2).coords + (start.shape[0],))


def _pool(g2: bool, n: int) -> list:
    """Affine points k G, k = 1..n, of G1 or G2."""
    gen, add, aff = ((cv.G2_GEN, cv.g2_add, cv.g2_to_affine) if g2
                     else (cv.G1_GEN, cv.g1_add, cv.g1_to_affine))
    pts, p = [], gen
    for _ in range(n):
        pts.append(aff(p))
        p = add(p, gen)
    return pts


INF = "inf"


def _records(g2: bool, pts: list) -> torch.Tensor:
    """Montgomery records of the points; INF is the (0, 0) record."""
    def coord(i, comp=None):
        vals = [0 if p == INF else (p[i] if comp is None else p[i][comp]) for p in pts]
        return lb.ints_to_limbs([fq_to_mont(v) if v else 0 for v in vals])

    if g2:
        xy = [torch.stack([coord(i, 0), coord(i, 1)]) for i in (0, 1)]
    else:
        xy = [coord(0), coord(1)]
    return msm.point_records(tuple(xy))


# Level 0 pieces over records 0..11 (k G, k = 1..12) and 12, 13 (the (0, 0)
# record): (record, negated) lanes. Pieces 0, 1, 5 and 9 sum to the identity
# (empty, (0, 0) alone, P - P, (0, 0) only); piece 8 doubles through the
# mixed add.
PIECES0 = [
    [],
    [(12, 0)],
    [(0, 0)],
    [(0, 1)],
    [(12, 0), (1, 0), (2, 1), (3, 0)],
    [(4, 0), (4, 1)],
    [(5, 0), (5, 1), (6, 0), (13, 0)],
    [(7, 1), (8, 1), (9, 1), (10, 1)],
    [(0, 0), (0, 0), (1, 0), (2, 0)],
    [(12, 0), (13, 0), (12, 0), (13, 0)],
    [(11, 0), (13, 0), (11, 1), (3, 0)],
]
IDENTITY0 = (0, 1, 5, 9)
# Level 1 pieces, runs (start, len) of level 0's sums: empty; identities
# alone and summed; P1 + (-P1); runs holding identities first and inside.
PIECES1 = [(0, 0), (0, 1), (2, 2), (4, 4), (8, 3), (9, 1), (5, 1), (0, 2), (1, 4)]
IDENTITY1 = (0, 1, 2, 5, 6, 7)


def _tables(pieces):
    """(start, len) of consecutive pieces, and their lanes in order."""
    start, length, lanes = [], [], []
    for p in pieces:
        start.append(len(lanes))
        length.append(len(p))
        lanes.extend(p)
    return (torch.tensor(start, dtype=torch.int64), torch.tensor(length, dtype=torch.int32),
            lanes)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_accumulate_edge_pieces_equal_plain(harness, g2):
    """Both accumulate levels on the hand-made pieces give the plain
    version's projective words, and the plain sums are what the pieces
    mean (the identity where they cancel)."""
    pts = _pool(g2, 12) + [INF, INF]
    rec = _records(g2, pts)
    start, length, lanes = _tables(PIECES0)
    order = torch.tensor([r for r, _ in lanes], dtype=torch.int32)
    negs = torch.tensor([bool(neg) for _, neg in lanes])
    want0 = msm.msm_bucket_sums_plain(g2, True, rec, order, negs, start, length)
    got0 = _host_level(harness, g2, True, rec, order, negs, start, length)
    assert torch.equal(got0, want0)
    start1 = torch.tensor([st for st, _ in PIECES1], dtype=torch.int64)
    length1 = torch.tensor([ln for _, ln in PIECES1], dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int32)
    want1 = msm.msm_bucket_sums_plain(g2, False, want0, none, none.bool(), start1, length1)
    got1 = _host_level(harness, g2, False, want0, none, none.bool(), start1, length1)
    assert torch.equal(got1, want1)
    # the pieces that sum to the identity: X = Z = 0
    for out, items in ((want0, IDENTITY0), (want1, IDENTITY1)):
        for i in items:
            assert not out[0, ..., i].any() and not out[2, ..., i].any()
            assert out[1, ..., i].any()


def _scalars(rng, n: int) -> torch.Tensor:
    """Bit-valued lanes first (most in bucket 1 of window 0), then uniform
    ones, a few full-width with a digit in every window, and zeros."""
    vals = [int(b) for b in rng.integers(0, 2, size=n // 2)]
    vals += [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n - n // 2)]
    vals[-4:] = [R_MOD - 1, R_MOD - 1, 0, 0]
    return lb.ints_to_limbs(vals)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_fold_levels_and_segments_equal_plain(harness, g2, monkeypatch):
    """A grouped MSM (two groups, c = 8, L = 4) over 96 lanes of 16 points
    and (0, 0) records: every level of bucket_fold_plan on the host equals
    msm_bucket_sums_plain, and the segments stage over the bucket sums
    (mostly empty: identity runs and triangles) equals
    msm_reduce_segments_plain at s = 16 and s = 4."""
    monkeypatch.setattr(msm, "BUCKET_PIECE", L)
    rng = np.random.default_rng(40 + g2)
    pool = _pool(g2, 16)
    n = 96
    pts = [pool[int(k)] for k in rng.integers(0, 16, size=n)]
    for i in (0, 5, 30, 31, n - 1):
        pts[i] = INF
    rec = _records(g2, pts)
    sizes = [60, n - 60]
    order, negs, ends = msm.sort_windows(_scalars(rng, n), sizes, C)
    windows, total = order.shape
    half = 1 << (C - 1)
    plan = msm.bucket_fold_plan(ends, windows, len(sizes), half, total)
    assert len(plan) >= 3  # the bit-valued lanes' bucket takes two fold levels
    order, negs = order.reshape(-1), negs.reshape(-1)
    src, affine = rec, True
    for start, length in plan:
        want = msm.msm_bucket_sums_plain(g2, affine, src, order, negs, start, length)
        got = _host_level(harness, g2, affine, src, order, negs, start, length)
        assert torch.equal(got, want)
        src, affine = want, False
    d, run = harness
    src.contiguous().numpy().tofile(d / "buckets.bin")
    ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
    rows = windows * len(sizes)
    for seg in (16, 4):
        s_plain, t_plain = msm.msm_reduce_segments_plain(ops, src, rows, half, seg)
        want = torch.cat([jc.point_stack(s_plain), jc.point_stack(t_plain)], dim=-1)
        got = run("seg", int(g2), d, rows, half, seg).reshape((2, 3) + ops.coords + (-1,))
        assert torch.equal(torch.cat([got[0], got[1]], dim=-1), want)
