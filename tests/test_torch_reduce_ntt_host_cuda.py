"""K14's passes (csrc/ntt_block_n.cuh) and the product reduction of K10 and
K17 (csrc/field_product.cuh) run on the host. A small program includes the
headers and is compiled by g++ against a stub `cuda_runtime.h` that defines
the CUDA qualifiers away: a block's threads are std::threads,
`__syncthreads` a std::barrier of them, and `__shfl_down_sync` an exchange
through a per-warp array between two barriers of the warp's 32 threads.

The passes run every block of a pass, at each field (bls12-377 Fr and the
bw6-761 Fr lazy, bls12-381 Fr canonical) and mode (forward, inverse, the
inverse's low = 0 pass with a (words, 1) and a (words, n) scale), over every
pass of small transforms at forced small tiles, and are held word for word
against `ntt_block_n_plain`. The product runs every block of a launch with
2, 3 and 4 accumulators a thread, long runs with an odd tail, empty spans
and one-warp blocks, at BN254 Fr (field.cuh's product) and the two 8-word
Fr (field_n.cuh's), and each partial is held against the product of its
span on Python integers. Skips where no g++ is installed."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import ntt

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
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// a warp: its 32 threads' slots and a barrier of them
struct StubWarp {
  unsigned slot[32];
  std::unique_ptr<std::barrier<>> bar;
};
inline std::vector<StubWarp>* stub_warps;
inline thread_local int stub_tid;
inline unsigned __shfl_down_sync(unsigned, unsigned v, int d) {
  StubWarp& w = (*stub_warps)[stub_tid >> 5];
  const int lane = stub_tid & 31;
  w.slot[lane] = v;
  w.bar->arrive_and_wait();
  const unsigned r = lane + d < 32 ? w.slot[lane + d] : v;
  w.bar->arrive_and_wait();
  return r;
}
"""

# ntt <field> <mode> <dir> <batch> <n> <low> <k> <tc> <inverse> <mul_lanes> <threads, 0: the
# launch's>: dir/{x,tw,mul}.bin -> dir/out.bin, every block of the pass
# prod <kind> <acc> <dir> <rows> <n> <blocks> <threads>: dir/in.bin -> dir/out.bin
PROGRAM = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include "field.cuh"
#include "ntt_block_n.cuh"
#include "field_product.cuh"

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

// one block: nt std::threads running body(t)
template <class Body> static void block(int nt, Body body) {
  std::barrier<> bar(nt);
  block_barrier = &bar;
  std::vector<StubWarp> warps((nt + 31) / 32);
  for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
  stub_warps = &warps;
  std::vector<std::thread> th;
  for (int t = 0; t < nt; t++)
    th.emplace_back([&, t] {
      stub_tid = t;
      body(t);
    });
  for (auto& x : th) x.join();
}

template <class F, int MODE>
static void ntt_pass(const std::string& d, long long batch, long long n, int low, int k, int tc,
                     int inverse, long long mul_lanes, int threads) {
  std::vector<u32> x = rd(d + "/x.bin"), tw = rd(d + "/tw.bin");
  std::vector<u32> mul = MODE == NTTN_SCALE ? rd(d + "/mul.bin") : std::vector<u32>(1);
  const int nt = threads ? threads : nb_block_threads(k + tc);
  std::vector<u32> sm((size_t)2 * F::N << (k + tc));
  for (long long b = 0; b < batch * (n >> (k + tc)); b++) {
    std::fill(sm.begin(), sm.end(), 0xdeadbeefu);
    block(nt, [&](int t) {
      ntt_block_n_body<F, MODE>(x.data(), tw.data(), mul.data(), mul_lanes, (int)batch, n, low,
                                k, tc, inverse != 0, sm.data(), b, t, nt);
    });
  }
  wr(d + "/out.bin", x);
}

template <class F>
static void ntt_mode(int mode, const std::string& d, long long batch, long long n, int low, int k,
                     int tc, int inverse, long long mul_lanes, int threads) {
  if (mode) ntt_pass<F, NTTN_SCALE>(d, batch, n, low, k, tc, inverse, mul_lanes, threads);
  else ntt_pass<F, NTTN_PLAIN>(d, batch, n, low, k, tc, inverse, mul_lanes, threads);
}

// the two field layers, as field_reduce.cu and field_reduce_n.cu wrap them
struct MulFr {
  static constexpr int N = 8;
  static void mul(u32* r, const u32* a, const u32* b) { fmul<Fr>(r, a, b); }
  static u32 one(int k) { return Fr::one(k); }
};
template <class F> struct MulN {
  static constexpr int N = F::N;
  static void mul(u32* r, const u32* a, const u32* b) { nmul<F>(r, a, b); }
  static u32 one(int k) { return F::one(k); }
};

template <class M, int ACC>
static void product(const std::string& d, long long rows, long long n, long long blocks, int nt) {
  std::vector<u32> in = rd(d + "/in.bin"), out(rows * M::N * blocks, 0xdeadbeefu);
  for (long long b = 0; b < rows * blocks; b++) {
    std::vector<u32> sm(product_smem_bytes(M::N, ACC) / 4, 0xdeadbeefu);
    block(nt, [&](int t) {
      product_reduce_body<M, ACC>(out.data(), in.data(), n, blocks, b, t, nt, sm.data());
    });
  }
  wr(d + "/out.bin", out);
}

template <class M>
static void product_acc(int acc, const std::string& d, long long rows, long long n,
                        long long blocks, int nt) {
  if (acc == 2) product<M, 2>(d, rows, n, blocks, nt);
  else if (acc == 3) product<M, 3>(d, rows, n, blocks, nt);
  else product<M, 4>(d, rows, n, blocks, nt);
}

int main(int argc, char** argv) {
  std::string what = argv[1], d = argv[4];
  int a = atoi(argv[2]), b = atoi(argv[3]);
  if (what == "ntt") {
    long long batch = atoll(argv[5]), n = atoll(argv[6]), lanes = atoll(argv[11]);
    int low = atoi(argv[7]), k = atoi(argv[8]), tc = atoi(argv[9]), inv = atoi(argv[10]);
    int threads = atoi(argv[12]);
    if (a == 0) ntt_mode<Bls377Fr>(b, d, batch, n, low, k, tc, inv, lanes, threads);
    else if (a == 1) ntt_mode<Bls377Fq>(b, d, batch, n, low, k, tc, inv, lanes, threads);
    else ntt_mode<Bls381Fr>(b, d, batch, n, low, k, tc, inv, lanes, threads);
  } else {
    long long rows = atoll(argv[5]), n = atoll(argv[6]), blocks = atoll(argv[7]);
    int nt = atoi(argv[8]);
    if (a == 0) product_acc<MulFr>(b, d, rows, n, blocks, nt);
    else if (a == 1) product_acc<MulN<Bls377Fr>>(b, d, rows, n, blocks, nt);
    else product_acc<MulN<Bls381Fr>>(b, d, rows, n, blocks, nt);
  }
}
"""

CURVES = ("bls12_377", "bw6_761", "bls12_381")  # K14's field selectors 0, 1, 2


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the headers on the host")
    d = tmp_path_factory.mktemp("reduce_ntt_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k.cpp").write_text(PROGRAM)
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread", f"-I{d}", f"-I{CSRC}",
                    str(d / "k.cpp"), "-o", str(d / "k")], check=True, capture_output=True,
                   timeout=600)

    def run(*args):
        subprocess.run([str(d / "k"), *map(str, args)], check=True, capture_output=True,
                       timeout=600)
        return np.fromfile(d / "out.bin", dtype=np.uint32)

    return d, run


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy()).view(np.uint32).reshape(-1)


def _values(rng, p: int, count: int) -> list:
    """Canonical values below p with 0, 1 and p - 1 up front."""
    nbytes = (p.bit_length() + 7) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(count)]
    vals[:3] = [0, 1, p - 1][:count]
    return vals


def _field(rng, spec, shape) -> torch.Tensor:
    """(..., words, n) canonical values of spec."""
    *lead, n = shape
    count = int(np.prod(lead, dtype=np.int64)) * n
    t = lb.ints_to_limbs(_values(rng, spec.modulus, count), "cpu", spec.words)
    return t.reshape(spec.words, *lead, n).movedim(0, -2).contiguous()


# (log_n, tile_log): a transform of several passes at each, the first pass
# contiguous, the strided ones with an odd k and with k = 1
NTT_CASES = [(6, 3), (7, 4), (8, 5), (9, 10)]


@pytest.mark.parametrize("log_n,tile_log", NTT_CASES)
@pytest.mark.parametrize("field", range(3), ids=CURVES)
def test_passes_equal_plain(harness, field, log_n, tile_log):
    """Every pass of the forward and the inverse transform of a (2, words,
    2^log_n) batch, run pass after pass on the host, equals
    ntt_block_n_plain's words, the inverse's low = 0 pass with the (words, 1)
    1/n and with a (words, n) table."""
    d, run = harness
    fr = cdev.curve_specs(CURVES[field])[1]
    assert fr.field_id == field
    rng = np.random.default_rng(40 + 10 * field + log_n)
    dom = ntt.NTTDomain(log_n, "cpu", fr)
    n = dom.n
    x = _field(rng, fr, (2, n))
    table = _field(rng, fr, (n,))
    passes = ntt.block_passes(log_n, tile_log, ntt.NTT_N_TILE_MIN_COLS_LOG)
    assert len(passes) > 1 or log_n <= tile_log
    _u32(dom.stw_fwd).tofile(d / "tw.bin")
    got, want = x, x
    for low, k, tc in passes:
        _u32(got).tofile(d / "x.bin")
        got = torch.from_numpy(run("ntt", field, 0, d, 2, n, low, k, tc, 0, 0, 0).view(np.int32))
        got = got.reshape(x.shape)
        want = ntt.ntt_block_n_plain(want, dom.stw_fwd, low, k, False, fr)
        assert torch.equal(got, want), (low, k, tc)
    _u32(dom.stw_inv).tofile(d / "tw.bin")
    for scale in (None, dom.n_inv_mont, table):
        got, want = x, x
        for low, k, tc in reversed(passes):
            s = scale if low == 0 else None
            _u32(got).tofile(d / "x.bin")
            if s is not None:
                _u32(s).tofile(d / "mul.bin")
            out = run("ntt", field, int(s is not None), d, 2, n, low, k, tc, 1,
                      0 if s is None else s.shape[-1], 0)
            got = torch.from_numpy(out.view(np.int32)).reshape(x.shape)
            want = ntt.ntt_block_n_plain(want, dom.stw_inv, low, k, True, fr, s)
            assert torch.equal(got, want), (low, k, tc, None if s is None else s.shape)


@pytest.mark.parametrize("field", range(3), ids=CURVES)
def test_pass_with_fewer_threads(harness, field):
    """A 2^8 tile run by 32 threads (each loops over eight pair items) gives
    the words of the plain pass."""
    d, run = harness
    fr = cdev.curve_specs(CURVES[field])[1]
    dom = ntt.NTTDomain(9, "cpu", fr)
    x = _field(np.random.default_rng(60 + field), fr, (1, dom.n))
    _u32(x).tofile(d / "x.bin")
    _u32(dom.stw_fwd).tofile(d / "tw.bin")
    got = run("ntt", field, 0, d, 1, dom.n, 0, 8, 0, 0, 0, 32).view(np.int32)
    want = ntt.ntt_block_n_plain(x, dom.stw_fwd, 0, 8, False, fr)
    assert torch.equal(torch.from_numpy(got).reshape(x.shape), want)


PRODUCT_FIELDS = [lb.FR_SPEC, cdev.curve_specs("bls12_377")[1], cdev.curve_specs("bls12_381")[1]]

# (rows, n, blocks, threads): long runs with an odd tail over two warps; a
# span past the row's end; a wrapper's second launch (one block over a few
# partials, most threads empty); one element; one warp (no shared step)
PRODUCT_CASES = [(2, 5003, 2, 64), (1, 3001, 4, 256), (3, 7, 1, 256), (1, 1, 1, 64),
                 (2, 999, 3, 32)]


@pytest.mark.parametrize("case", PRODUCT_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("acc", [2, 3, 4])
@pytest.mark.parametrize("kind", range(3), ids=[s.name for s in PRODUCT_FIELDS])
def test_product_partials_equal_integers(harness, kind, acc, case):
    """Each (row, block) partial is the Montgomery product of its span's
    elements, the Montgomery one for an empty span."""
    d, run = harness
    rows, n, blocks, threads = case
    spec = PRODUCT_FIELDS[kind]
    p, w = spec.modulus, spec.words
    rng = np.random.default_rng(70 + kind + 10 * acc + n)
    vals = [_values(rng, p, n) for _ in range(rows)]
    for r in vals[1:]:
        r[:3] = [p - 1, p - 1, 1][: len(r[:3])]  # no zero: a product that can move
    x = torch.stack([lb.ints_to_limbs(r, "cpu", w) for r in vals])
    _u32(x).tofile(d / "in.bin")
    got = run("prod", kind, acc, d, rows, n, blocks, threads).reshape(rows, w, blocks)
    rinv = pow(1 << (32 * w), -1, p)
    chunk = -(-n // blocks)
    for r in range(rows):
        for b in range(blocks):
            want = spec.r_mod
            for v in vals[r][b * chunk:(b + 1) * chunk]:
                want = want * v * rinv % p
            word = sum(int(got[r, k, b]) << (32 * k) for k in range(w))
            assert word == want, (r, b)
