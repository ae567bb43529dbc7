"""K3's register passes (csrc/ntt_radix.cuh) run on the host. A small program
includes the header and is compiled by g++ against a stub `cuda_runtime.h`
that defines the CUDA qualifiers away, once for each field layer: field.cuh's
BN254 Fr (K3) and field_n.cuh's bls12-377 Fr, bw6-761 Fr and bls12-381 Fr
(K14's instances). A pass's threads share nothing, so the program runs
every thread of a pass one after another.

Every pass of a transform of 2^7 (batch 2) at each R the layer takes, both
directions, the inverse's low = 0 pass with and without the (words, 1)
scale, the first pass on the 16-byte vector path and on the scalar one
(an x that is not 16-byte aligned), is held
word for word against `ntt_radix_n_plain`; K3's one-stage entry (R = 1 over
the natural power table) against `ntt_stage_plain` at every span. Skips
where no g++ is installed."""

import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
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
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline void __syncthreads() {}
"""

# <field> <dir> <batch> <n> <low> <r> <inverse> <scaled> <natural> <vec>:
# dir/{x,tw,scale}.bin -> dir/out.bin, every thread of the pass. field: 9 for
# BN254 Fr (the FR layer), else the K12 selector (the N layer).
PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#include "ntt_radix.cuh"

static std::vector<u32> rd(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<u32> v(n / 4 + 4);  // + 4: room to offset the scalar path's x
  if (n && fread(v.data(), 1, n, f) != (size_t)n) exit(3);
  fclose(f);
  return v;
}

struct Args {
  std::string d;
  long long batch, n;
  int low, inverse, scaled, vec;
};

template <class A, int R, bool INV, bool NAT>
static void pass(const Args& a) {
  std::vector<u32> buf = rd(a.d + "/x.bin"), tw = rd(a.d + "/tw.bin");
  std::vector<u32> sc = a.scaled ? rd(a.d + "/scale.bin") : std::vector<u32>(1);
  // the scalar path on an x that is not 16-byte aligned
  u32* x = buf.data();
  if (!a.vec) {
    for (long long i = (long long)buf.size() - 5; i >= 0; i--) buf[i + 1] = buf[i];
    x = buf.data() + 1;
  }
  const long long threads = a.batch * (a.n >> R);
  for (long long g = 0; g < threads; g++)
    ntt_radix_body<A, R, INV, NAT>(x, tw.data(), a.scaled ? sc.data() : nullptr, a.n, a.low, g,
                                   a.vec != 0);
  FILE* f = fopen((a.d + "/out.bin").c_str(), "wb");
  fwrite(x, 4, (size_t)a.batch * A::N * a.n, f);
  fclose(f);
}

template <class A, int R>
static void by_dir(const Args& a, int natural) {
  if constexpr (R == 1) {
    if (natural) {
      if (a.inverse) pass<A, 1, true, true>(a); else pass<A, 1, false, true>(a);
      return;
    }
  }
  if (a.inverse) pass<A, R, true, false>(a); else pass<A, R, false, false>(a);
}

template <class A>
static void by_r(const Args& a, int r, int natural) {
  switch (r) {
    case 1: by_dir<A, 1>(a, natural); break;
    case 2: by_dir<A, 2>(a, natural); break;
    case 3: by_dir<A, 3>(a, natural); break;
    default:
      if constexpr (A::R_MAX >= 4) by_dir<A, 4>(a, natural); else exit(4);
  }
}

int main(int argc, char** argv) {
  const int field = atoi(argv[1]);
  Args a{argv[2], atoll(argv[3]), atoll(argv[4]), atoi(argv[5]), atoi(argv[7]), atoi(argv[8]),
         atoi(argv[10])};
  const int r = atoi(argv[6]), natural = atoi(argv[9]);
#ifdef LAYER_FR
  if (field != 9) exit(5);
  by_r<RadixFr>(a, r, natural);
#else
  switch (field) {
    case 0: by_r<RadixN<Bls377Fr>>(a, r, natural); break;
    case 1: by_r<RadixN<Bls377Fq>>(a, r, natural); break;
    case 2: by_r<RadixN<Bls381Fr>>(a, r, natural); break;
    default: exit(5);
  }
#endif
}
"""

BN254 = 9
# (layer field id, curve): K3's BN254 Fr, then K14's selectors 0, 1, 2
FIELDS = {"bn254": BN254, "bls12_377": 0, "bw6_761": 1, "bls12_381": 2}


def _spec(name):
    return lb.FR_SPEC if name == "bn254" else cdev.curve_specs(name)[1]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the header on the host")
    d = tmp_path_factory.mktemp("ntt_radix_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k.cpp").write_text(PROGRAM)

    def build(layer):
        subprocess.run([gxx, "-std=c++17", "-O1", "-w", f"-DLAYER_{layer}", f"-I{d}",
                        f"-I{CSRC}", str(d / "k.cpp"), "-o", str(d / layer)], check=True,
                       capture_output=True, timeout=900)

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build, ("FR", "N")))

    def run(field, *args):
        exe = d / ("FR" if field == BN254 else "N")
        subprocess.run([str(exe), str(field), *map(str, args)], check=True, capture_output=True,
                       timeout=600)
        return np.fromfile(d / "out.bin", dtype=np.uint32)

    return d, run


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy()).view(np.uint32).reshape(-1)


def _field(rng, spec, shape) -> torch.Tensor:
    """(..., words, n) canonical values of spec with 0, 1 and p - 1 up front."""
    *lead, n = shape
    count = int(np.prod(lead, dtype=np.int64)) * n
    nbytes = (spec.modulus.bit_length() + 7) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % spec.modulus for _ in range(count)]
    vals[:3] = [0, 1, spec.modulus - 1]
    t = lb.ints_to_limbs(vals, "cpu", spec.words)
    return t.reshape(spec.words, *lead, n).movedim(0, -2).contiguous()


LOG_N = 7
CASES = [(name, r) for name in FIELDS for r in (1, 2, 3, 4)
         if r <= ntt.RADIX_MAX[_spec(name).words]]


@pytest.mark.parametrize("name,r", CASES, ids=lambda v: str(v))
def test_passes_equal_plain(harness, name, r):
    """Every pass of the forward and the inverse transform of (2, words,
    2^7) at r stages a pass, run pass after pass on the host, equals
    ntt_radix_n_plain's words; the inverse's low = 0 pass with the 1/n and
    without; the first pass on the vector path and on the scalar one."""
    d, run = harness
    field, spec = FIELDS[name], _spec(name)
    rng = np.random.default_rng(1000 + 10 * field + r)
    dom = ntt.NTTDomain(LOG_N, "cpu", spec)
    n = dom.n
    x = _field(rng, spec, (2, n))
    passes = ntt.radix_passes(LOG_N, r)
    assert len(passes) > 1

    def host(y, stw, low, k, inverse, scale, vec):
        _u32(y).tofile(d / "x.bin")
        _u32(stw).tofile(d / "tw.bin")
        if scale is not None:
            _u32(scale).tofile(d / "scale.bin")
        out = run(field, d, 2, n, low, k, int(inverse), int(scale is not None), 0, vec)
        return torch.from_numpy(out.view(np.int32)).reshape(x.shape)

    got = want = x
    for low, k in passes:
        for vec in ((1, 0) if low == 0 else (0,)):
            step = host(got, dom.stw_fwd, low, k, False, None, vec)
            assert torch.equal(step, ntt.ntt_radix_n_plain(want, dom.stw_fwd, low, k, False,
                                                           spec)), (low, k, vec)
        got = want = step
    for scale in (dom.n_inv_mont, None):
        got = want = x
        for low, k in reversed(passes):
            s = scale if low == 0 else None
            for vec in ((1, 0) if low == 0 else (0,)):
                step = host(got, dom.stw_inv, low, k, True, s, vec)
                assert torch.equal(step, ntt.ntt_radix_n_plain(want, dom.stw_inv, low, k, True,
                                                               spec, s)), (low, k, vec)
            got = want = step


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_one_stage_entry_on_the_natural_table(harness, inverse):
    """K3's one-stage entry (R = 1 over the natural (8, n) power table, as
    snark_ntt_stage runs it) equals ntt_stage_plain at every span of 2^7,
    with and without the scale, on both load paths of the first stage."""
    d, run = harness
    dom = ntt.NTTDomain(LOG_N, "cpu")
    n = dom.n
    x = _field(np.random.default_rng(1100 + inverse), lb.FR_SPEC, (2, n))
    tw = dom.tw_inv if inverse else dom.tw_fwd
    _u32(tw).tofile(d / "tw.bin")
    _u32(dom.n_inv_mont).tofile(d / "scale.bin")
    for s in range(1, LOG_N + 1):
        for scaled in (0, 1):
            for vec in ((1, 0) if s == 1 else (0,)):
                _u32(x).tofile(d / "x.bin")
                out = run(BN254, d, 2, n, s - 1, 1, int(inverse), scaled, 1, vec)
                got = torch.from_numpy(out.view(np.int32)).reshape(x.shape)
                want = ntt.ntt_stage_plain(x, tw, 1 << s, inverse,
                                           dom.n_inv_mont if scaled else None)
                assert torch.equal(got, want), (s, scaled, vec)
