"""The bodies of the sharded and out-of-core prove's two kernels run on the
host: K6's tree sum of window-sum stacks (csrc/point_sum.cuh, G1 on one
thread and G2 on a thread pair a lane) and K15's twiddle pass (csrc/four_step.cuh). A
small program includes the headers and is compiled by g++ against a stub
`cuda_runtime.h` that defines the CUDA qualifiers away: a block's threads
are std::threads, `__syncthreads` a std::barrier of them, `__shfl_xor_sync`
an exchange through a per-pair slot between two barriers of the pair, and
cp.async (the headers' host branch) a copy before its wait.

K6 runs every block of a launch over S stacks of random projective points
with identities, P + P and P + (-P) in them, at ragged lane counts and with
deep stacks (fewer lanes a block), and is held word for word against
`sum_windows_plain`. K15 runs every block of a pass, forward and inverse,
on the first and the last shard, at each tile, at shapes below a tile (the
zero-filled edge), n1 = 2, and a batch of more rows than one round stages,
and is held word for word against
`four_step_twiddle_plain`. Skips where no g++ is installed."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.parallel import ntt_dist
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import Q as Q_MOD, fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "icicle_snark_tpu_torch" / "csrc"

STUB = """#pragma once
#include <barrier>
#include <cstdint>
#include <memory>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct uint4 { unsigned x, y, z, w; };
template <class T> inline T __ldg(const T* p) { return *p; }
struct HostDim { unsigned x; };
inline thread_local HostDim threadIdx;
inline std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// a thread pair: its two slots and a barrier of the two
struct StubPair {
  unsigned slot[2];
  std::unique_ptr<std::barrier<>> bar;
};
inline std::vector<StubPair>* stub_pairs;
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int) {
  StubPair& p = (*stub_pairs)[threadIdx.x >> 1];
  p.slot[threadIdx.x & 1] = v;
  p.bar->arrive_and_wait();
  const unsigned r = p.slot[(threadIdx.x & 1) ^ 1];
  p.bar->arrive_and_wait();
  return r;
}
"""

# sum <g2> 0 <dir> <s> <n>: dir/in.bin (s, 3, C, 8, n) -> dir/out.bin, every block
# four <tile> 0 <dir> <batch> <n1> <n2_loc> <d> <shard> <s_log>:
#   dir/{x,tlo,thi}.bin -> dir/out.bin, every block of the pass
PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include "point_sum.cuh"
#include "four_step.cuh"

static std::vector<u32> rd(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<u32> v(n / 4);
  if (n && fread(v.data(), 1, n, f) != (size_t)n) exit(3);
  fclose(f);
  return v;
}

static void wr(const std::string& path, const std::vector<u32>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

// one block: nt std::threads running body(t), threadIdx.x = t
template <class Body> static void block(int nt, Body body) {
  std::barrier<> bar(nt);
  block_barrier = &bar;
  std::vector<StubPair> pairs((nt + 1) / 2);
  for (auto& p : pairs) p.bar = std::make_unique<std::barrier<>>(2);
  stub_pairs = &pairs;
  std::vector<std::thread> th;
  for (int t = 0; t < nt; t++)
    th.emplace_back([&, t] {
      threadIdx.x = t;
      body(t);
    });
  for (auto& x : th) x.join();
}

template <class L> static void sum(const std::string& d, long long s, long long n) {
  std::vector<u32> in = rd(d + "/in.bin"), out(L::W3 * n, 0xdeadbeefu);
  int half, lb;
  point_sum_shape(s, n, L::SHIFT, half, lb);
  for (long long b = 0; b < (n + lb - 1) / lb; b++) {
    std::vector<u32> sm((size_t)half * L::W3 * lb, 0xdeadbeefu);
    block((half << L::SHIFT) * lb, [&](int t) {
      point_sum_body<L>(out.data(), in.data(), s, n, half, lb, b, t, sm.data());
    });
  }
  wr(d + "/out.bin", out);
}

template <int TK1, int TI2>
static void four(const std::string& dir, long long batch, long long n1, long long n2_loc,
                 long long d, long long shard, int s_log) {
  std::vector<u32> x = rd(dir + "/x.bin"), lo = rd(dir + "/tlo.bin"), hi = rd(dir + "/thi.bin");
  std::vector<u32> out(batch * n1 * 8 * n2_loc, 0xdeadbeefu);
  const int rows = batch < FS_ROWS ? (int)batch : FS_ROWS;
  for (long long by = 0; by < (n2_loc + TI2 - 1) / TI2; by++)
    for (long long bx = 0; bx < (n1 + TK1 - 1) / TK1; bx++) {
      std::vector<u32> st(four_step_smem_words<TK1, TI2>(rows), 0xdeadbeefu);
      block(TK1 * TI2, [&](int t) {
        four_step_body<TK1, TI2>(out.data(), x.data(), lo.data(), hi.data(), batch, n1, n2_loc,
                                 d, shard, s_log, bx, by, t, st.data());
      });
    }
  wr(dir + "/out.bin", out);
}


int main(int argc, char** argv) {
  std::string what = argv[1], d = argv[4];
  int a = atoi(argv[2]), b = atoi(argv[3]);
  if (what == "sum") {
    if (a) sum<SumG2Pair>(d, atoll(argv[5]), atoll(argv[6]));
    else sum<SumG1>(d, atoll(argv[5]), atoll(argv[6]));
  } else {
    long long batch = atoll(argv[5]), n1 = atoll(argv[6]), n2 = atoll(argv[7]);
    long long dd = atoll(argv[8]), shard = atoll(argv[9]);
    int s_log = atoi(argv[10]);
    if (a == 0) four<32, 8>(d, batch, n1, n2, dd, shard, s_log);
    else if (a == 1) four<32, 16>(d, batch, n1, n2, dd, shard, s_log);
    else four<64, 8>(d, batch, n1, n2, dd, shard, s_log);
  }
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the headers on the host")
    d = tmp_path_factory.mktemp("sharded_kernels_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k.cpp").write_text(PROGRAM)
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread", f"-I{d}", f"-I{CSRC}",
                    str(d / "k.cpp"), "-o", str(d / "k")], check=True, capture_output=True,
                   timeout=600)

    def run(*args):
        subprocess.run([str(d / "k"), *map(str, args)], check=True, capture_output=True,
                       timeout=600)
        return torch.from_numpy(np.fromfile(d / "out.bin", dtype=np.uint32).view(np.int32))

    return d, run


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy()).view(np.uint32).reshape(-1)


# ---------------------------------------------------------------- K6

def _pool(g2: bool, count: int = 12) -> list:
    """Affine points k G (host ints)."""
    rng = np.random.default_rng(80 + g2)
    mul, gen, aff = ((cv.g2_mul, cv.G2_GEN, cv.g2_to_affine) if g2 else
                     (cv.g1_mul, cv.G1_GEN, cv.g1_to_affine))
    return [aff(mul(gen, int(k))) for k in rng.integers(1, 1 << 30, size=count)]


def _limbs(vals: list, g2: bool) -> torch.Tensor:
    """Fq (8, n) or Fq2 (2, 8, n) standard-form ints -> Montgomery limbs."""
    if g2:
        return torch.stack([lb.ints_to_limbs([fq_to_mont(v[c]) for v in vals]) for c in range(2)])
    return lb.ints_to_limbs([fq_to_mont(v) for v in vals])


def _stacks(g2: bool, s: int, n: int, seed: int) -> torch.Tensor:
    """(s, 3, [2,] 8, 1, n): random points of the pool in projective form (X,
    Y, Z) = (x l, y l, l) for a random l, with the identity in stack 0 at
    lane 0, in stack 1 at lane 1, in both at lane 2, stack 1 holding P at
    lane 3 and -P at lane 4 where stack 0 holds P, and every stack the
    identity at the last lane."""
    rng = np.random.default_rng(seed)
    pool = _pool(g2)
    fmul = (lambda a, l: ((a[0] * l) % Q_MOD, (a[1] * l) % Q_MOD)) if g2 else \
        (lambda a, l: a * l % Q_MOD)
    zero, one = ((0, 0), (1, 0)) if g2 else (0, 1)
    pts = [[None] * n for _ in range(s)]
    for k in range(s):
        for i in range(n):
            x, y = pool[int(rng.integers(len(pool)))]
            lam = int(rng.integers(1, 1 << 62))
            pts[k][i] = (fmul(x, lam), fmul(y, lam), (lam, 0) if g2 else lam)
    ident = (zero, one, zero)
    pts[0][0], pts[1][1], pts[0][2], pts[1][2] = ident, ident, ident, ident
    if n > 4:
        pts[1][3] = pts[0][3]
        x, y, z = pts[0][4]
        pts[1][4] = (x, ((-y[0]) % Q_MOD, (-y[1]) % Q_MOD) if g2 else (-y) % Q_MOD, z)
    for k in range(s):
        pts[k][n - 1] = ident
    return torch.stack([torch.stack([_limbs([p[c] for p in stack], g2) for c in range(3)])
                        for stack in pts]).unsqueeze(-2).contiguous()


@pytest.mark.parametrize("s", [2, 3, 5, 8])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2-pair"])
def test_point_sum_equals_plain(harness, g2, s):
    """Every block of a launch over s stacks at 37 lanes (two blocks of 32
    lanes, the second ragged) and at 6 (one block of 6) gives
    `sum_windows_plain`'s words; at s = 2, those of `acc_windows`."""
    d, run = harness
    for n in (37, 6):
        stacks = _stacks(g2, s, n, seed=10 * s + n + g2)
        _u32(stacks).tofile(d / "in.bin")
        got = run("sum", int(g2), 0, d, s, n).reshape(stacks.shape[1:])
        want = msm.sum_windows_plain(stacks)
        assert torch.equal(got, want), (s, n)
        if s == 2:
            assert torch.equal(got, msm.acc_windows(stacks[0], stacks[1]))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2-pair"])
def test_point_sum_deep_stacks(harness, g2):
    """40 stacks pad to 64: 32 tree threads a lane, so a block holds 32 lanes
    (16 on the pair: 1024 threads), over three (five) blocks at 70 lanes."""
    d, run = harness
    stacks = _stacks(g2, 40, 70, seed=7 + g2)
    _u32(stacks).tofile(d / "in.bin")
    got = run("sum", int(g2), 0, d, 40, 70).reshape(stacks.shape[1:])
    assert torch.equal(got, msm.sum_windows_plain(stacks))
    ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
    chain = stacks[0]
    for k in range(1, 40):
        chain = msm.acc_windows(chain, stacks[k])
    assert bool(jc.points_equal(ops, jc.point_unstack(got.flatten(-2)),
                                jc.point_unstack(chain.flatten(-2))).all())


# ---------------------------------------------------------------- K15

# (log_n1, log_n2, d, batch): the tiles' own size, the swapped orientation,
# tiles past the edge on both axes (n1 = 16, n2/d = 4), n1 = 2, and a batch
# of five (two rounds of staging)
FOUR_CASES = [(5, 5, 4, 3), (6, 4, 2, 3), (4, 3, 2, 3), (1, 2, 2, 2), (5, 4, 2, 5)]


@pytest.mark.parametrize("case", FOUR_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("tile", range(len(ntt_dist.FOUR_STEP_TILES)),
                         ids=["x".join(map(str, t)) for t in ntt_dist.FOUR_STEP_TILES])
def test_four_step_equals_plain(harness, tile, case):
    """Every block of the pass, forward and inverse, first and last shard,
    gives `four_step_twiddle_plain`'s words."""
    d, run = harness
    l1, l2, dd, batch = case
    n1, n2_loc = 1 << l1, (1 << l2) // dd
    log_n = l1 + l2
    rng = np.random.default_rng(100 * tile + log_n + batch)
    vals = [int.from_bytes(rng.bytes(32), "little") % lb.FR_SPEC.modulus
            for _ in range(batch * n2_loc * n1)]
    vals[:3] = [0, 1, lb.FR_SPEC.modulus - 1]
    x = lb.ints_to_limbs(vals, "cpu").reshape(8, batch, n2_loc, n1).permute(1, 2, 0, 3)
    x = x.contiguous()
    _u32(x).tofile(d / "x.bin")
    for inverse in (False, True):
        tables = ntt_dist.twiddle_tables(log_n, "cpu", inverse)
        _u32(tables[0]).tofile(d / "tlo.bin")
        _u32(tables[1]).tofile(d / "thi.bin")
        for shard in (0, dd - 1):
            want = ntt_dist.four_step_twiddle_plain(x, tables, shard, dd)
            got = run("four", tile, 0, d, batch, n1, n2_loc, dd, shard, tables[2])
            assert torch.equal(got.reshape(want.shape), want), (inverse, shard)
