"""The device setup's two point kernels run on the host: K11's G1 window
loop (csrc/fq_lazy.cuh, lazy Fq arithmetic, the block's windows staged in
shared memory) and K7 point_to_affine's batched inverse
(csrc/affine_batch.cuh). A
small program includes the headers and is compiled by g++ against a stub
`cuda_runtime.h` that defines the CUDA qualifiers away; `__syncthreads` is
a barrier of the block's threads, run as std::threads, and cp.async is the
header's plain copy. Held word for word against the plain versions
(setup/fast_setup.py fixed_base_msm_plain, curve/jcurve.py to_affine_plain):
the edge scalars 0, 1, r - 1 and 2^256 - 1; G1 and G2 points with the
identity at lane 0, a run of 40 infinity lanes, L-lane groups that are all
infinity and mixed ones, and a lane count that no L divides. The lazy
operations themselves are held against Python integers at their bounds.
Skips where no g++ is installed."""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.refmath.field import Q, R_MOD
from icicle_snark_tpu_torch.setup import fast_setup as fs
from icicle_snark_tpu_torch.setup.trusted_setup import _fixed_bases

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "icicle_snark_tpu_torch" / "csrc"
R = 1 << 256

STUB = """#pragma once
#include <barrier>
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct uint4 { unsigned x, y, z, w; };
template <class T> inline T __ldg(const T* p) { return *p; }
inline std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
"""

PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>
#include "fq_lazy.cuh"
#include "affine_batch.cuh"

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

// K11 G1 over n lanes in blocks of nt threads, a std::thread each
static void fixed_base(const std::string& d, long long n, int nt) {
  std::vector<u32> sc = rd(d + "/scalars.bin"), table = rd(d + "/table.bin");
  std::vector<u32> out(3 * 8 * n, 0xdeadbeefu);
  for (long long b = 0; b * nt < n; b++) {
    std::vector<u32> buf(2 * 4096, 0xdeadbeefu);
    std::barrier<> bar(nt);
    block_barrier = &bar;
    std::vector<std::thread> th;
    for (int t = 0; t < nt; t++)
      th.emplace_back([&, t] {
        fixed_base_g1_lane(out.data(), sc.data(), table.data(), n, b * nt + t, t, nt, buf.data());
      });
    for (auto& x : th) x.join();
  }
  wr(d + "/out.bin", out);
}

template <class E, int L> static void affine(const std::string& d, long long n) {
  std::vector<u32> in = rd(d + "/in.bin");
  constexpr int W = ECoord<E>::WORDS;
  std::vector<u32> ox(W * n, 0xdeadbeefu), oy(W * n, 0xdeadbeefu);
  long long T = (n + L - 1) / L;
  for (long long t = 0; t < T; t++) affine_batch_thread<E, L>(ox.data(), oy.data(), in.data(), n, t, T);
  ox.insert(ox.end(), oy.begin(), oy.end());
  wr(d + "/out.bin", ox);
}

template <class E> static void affine_l(const std::string& d, long long n, int lanes) {
  if (lanes == 4) affine<E, 4>(d, n);
  else if (lanes == 8) affine<E, 8>(d, n);
  else if (lanes == 16) affine<E, 16>(d, n);
  else affine<E, 32>(d, n);
}

// the lazy operations on (a, b) pairs of 8-word values: mul, add, sub,
// mul9(a), canon(a) a pair
static void lazy(const std::string& d) {
  std::vector<u32> in = rd(d + "/in.bin"), out;
  for (size_t p = 0; p + 16 <= in.size(); p += 16) {
    E1 a, b;
    for (int k = 0; k < 8; k++) { a.v[k] = in[p + k]; b.v[k] = in[p + 8 + k]; }
    E1 r[5] = {fq_lz_mul(a, b), fq_lz_add(a, b), fq_lz_sub(a, b), fq_lz_mul9(a), fq_lz_canon(a)};
    for (auto& x : r) out.insert(out.end(), x.v, x.v + 8);
  }
  wr(d + "/out.bin", out);
}

int main(int argc, char** argv) {
  std::string mode = argv[1], d = argv[2];
  if (mode == "lazy") lazy(d);
  else if (mode == "fb") fixed_base(d, atoll(argv[3]), atoi(argv[4]));
  else if (atoi(argv[3])) affine_l<E2>(d, atoll(argv[4]), atoi(argv[5]));
  else affine_l<E1>(d, atoll(argv[4]), atoi(argv[5]));
}
"""

LANES = (4, 8, 16, 32)
N_AFFINE = 301  # no L divides it


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the headers on the host")
    d = tmp_path_factory.mktemp("setup_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "setup.cpp").write_text(PROGRAM)
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread", f"-I{d}", f"-I{CSRC}",
                    str(d / "setup.cpp"), "-o", str(d / "setup")], check=True,
                   capture_output=True, timeout=600)

    def run(*args):
        subprocess.run([str(d / "setup"), *map(str, args)], check=True, capture_output=True,
                       timeout=600)
        return np.fromfile(d / "out.bin", dtype=np.uint32)

    return d, run


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy()).view(np.uint32).reshape(-1)


def _ints_words(vals) -> np.ndarray:
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for v in vals],
                    dtype=np.uint32)


def test_lazy_ops_against_integers(harness):
    """mul, add, sub, mul9 and canon of the header on operands in [0, 2q),
    2q - 1 and q among them: each output below 2q (canon below q) and the
    residue of its integer counterpart."""
    d, run = harness
    prng = random.Random(10)
    edges = [0, 1, Q - 1, Q, Q + 1, 2 * Q - 2, 2 * Q - 1]
    vals = edges + [prng.randrange(2 * Q) for _ in range(40)]
    pairs = [(a, b) for a in vals for b in edges] + [(b, a) for a in vals for b in edges]
    np.concatenate([_ints_words([a, b]) for a, b in pairs]).tofile(d / "in.bin")
    out = run("lazy", d).reshape(len(pairs), 5, 8)
    rinv = pow(R, -1, Q)
    for (a, b), words in zip(pairs, out):
        mul, add, sub, mul9, canon = (sum(int(w) << (32 * k) for k, w in enumerate(ws))
                                      for ws in words)
        assert mul < 2 * Q and mul % Q == a * b * rinv % Q
        assert add < 2 * Q and add % Q == (a + b) % Q
        assert sub < 2 * Q and sub % Q == (a - b) % Q
        assert mul9 < 2 * Q and mul9 % Q == 9 * a % Q
        assert canon == a % Q


def _scalars(n: int) -> torch.Tensor:
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    words[: n // 2, 7] &= 0x3FFFFFFF  # half below 2^254, half full width
    for i, v in enumerate((0, 1, R_MOD - 1, R - 1)):
        words[i] = _ints_words([v])[0]
    words[4, 0] = 0  # zero digits in the low windows
    words[4, 1] = 0
    return lb.words_to_limbs(words, "cpu")


@pytest.fixture(scope="module")
def g1_case(harness):
    d, _ = harness
    fb1, _ = _fixed_bases()
    table = fs._table_g1(fb1, "cpu")
    sc = _scalars(150)
    _u32(msm.point_records(table)).tofile(d / "table.bin")
    _u32(sc).tofile(d / "scalars.bin")
    want = fs.fixed_base_msm_plain(sc, table, jc.G1_PLAIN)
    return sc.shape[-1], _u32(torch.stack(want))


@pytest.mark.parametrize("threads", [64, 256])
def test_fixed_base_g1_equals_plain(harness, g1_case, threads):
    """K11's G1 loop gives the plain scan's projective words on 150 lanes, in
    blocks of 64 threads (three blocks, the last part empty) and of 256 (the
    kernel's block: one block, most of it past n)."""
    _, run = harness
    n, want = g1_case
    got = run("fb", harness[0], n, threads)
    assert np.array_equal(got, want)


def _infinity_lanes(n: int) -> set:
    """Lane 0 (the planted identity), a run of 40, and every lane of thread
    1's group for each L (all-infinity groups)."""
    lanes = {0, *range(100, 140)}
    for lanes_a_thread in LANES:
        t = -(-n // lanes_a_thread)
        lanes |= {1 + k * t for k in range(lanes_a_thread) if 1 + k * t < n}
    return lanes


def _projective(g2: bool, n: int):
    rng = np.random.default_rng(12 + g2)
    coords = (2, 8) if g2 else (8,)

    def field():
        count = int(np.prod(coords[:-1], dtype=np.int64)) * n
        w = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64).astype(np.uint32)
        w[:, 7] = rng.integers(0, Q >> 224, size=count).astype(np.uint32)
        return lb.words_to_limbs(w, "cpu").reshape(8, *coords[:-1], n).movedim(0, -2)

    x, y, z = field(), field(), field()
    inf = sorted(_infinity_lanes(n))
    z[..., inf] = 0
    y[..., 0] = 0  # the identity as a setup's zero scalar gives it: (0, one, 0)
    y[..., 0, 0] = 1
    return tuple(t.contiguous() for t in (x, y, z))


@pytest.fixture(scope="module")
def affine_cases():
    out = {}
    for g2 in (False, True):
        p = _projective(g2, N_AFFINE)
        ax, ay = jc.to_affine_plain(jc.G2_PLAIN if g2 else jc.G1_PLAIN, p)
        out[g2] = (p, np.concatenate([_u32(ax), _u32(ay)]))
    return out


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_point_to_affine_equals_plain(harness, affine_cases, g2, lanes):
    d, run = harness
    p, want = affine_cases[g2]
    _u32(torch.stack(p)).tofile(d / "in.bin")
    got = run("aff", d, int(g2), N_AFFINE, lanes)
    assert np.array_equal(got, want)
    inf = sorted(_infinity_lanes(N_AFFINE))
    assert not got.reshape(2, -1, N_AFFINE)[:, :, inf].any()  # infinity -> (0, 0)
