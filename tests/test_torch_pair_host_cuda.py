"""The thread-pair G2 doubling of csrc/curve_pair.cuh (K7 point_dbl_k on
G2), run on the host: a small program includes the header and is compiled
by g++ against a stub `cuda_runtime.h` in which the two threads of a pair
are two std::threads and `__shfl_xor_sync` swaps their words through a
barrier. Each case loads lane 0's components of a (3, 2, 8, 1) point the
way the kernel does, runs the pair's doublings, stores, and is held word
for word against the plain version (curve/jcurve.py pdbl_k_plain on
G2_PLAIN). Skips where no g++ is installed."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "icicle_snark_tpu_torch" / "csrc"

STUB = """#pragma once
#include <barrier>
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct uint4 { unsigned x, y, z, w; };
template <class T> inline T __ldg(const T* p) { return *p; }
struct HostDim { unsigned x; };
inline thread_local HostDim threadIdx;
inline std::barrier<>& pair_barrier() { static std::barrier<> b(2); return b; }
inline unsigned pair_slot[2];
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int) {
  pair_slot[threadIdx.x & 1] = v;
  pair_barrier().arrive_and_wait();
  unsigned r = pair_slot[(threadIdx.x & 1) ^ 1];
  pair_barrier().arrive_and_wait();
  return r;
}
inline int __shfl_xor_sync(unsigned m, int v, int l) {
  return (int)__shfl_xor_sync(m, (unsigned)v, l);
}
"""

# reads "k <48 point words>" lines of hex words (k doublings), writes the 48
# words of the result
PROGRAM = r"""
#include <cstdio>
#include <iostream>
#include <string>
#include <thread>
#include "curve_pair.cuh"
int main() {
  int k;
  while (std::cin >> k) {
    u32 pt[48], out[48];
    for (int w = 0; w < 48; w++) { std::string s; std::cin >> s; pt[w] = (u32)std::stoul(s, nullptr, 16); }
    auto lane = [&](unsigned c) {
      threadIdx.x = c;
      PairLane pl = pair_lane();
      Pt<E1> p = pair_load(pt, 1, 0, pl);
      for (int s = 0; s < k; s++) p = pair_dbl(p, pl);
      pair_store(out, 1, 0, pl, p);
    };
    std::thread even(lane, 0u), odd(lane, 1u);
    even.join();
    odd.join();
    for (int w = 0; w < 48; w++) printf("%x ", out[w]);
    printf("\n");
  }
}
"""


@pytest.fixture(scope="module")
def pair_ops(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the header on the host")
    d = tmp_path_factory.mktemp("pair_cuda")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "pair.cpp").write_text(PROGRAM)
    subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-pthread", f"-I{d}", f"-I{CSRC}",
                    str(d / "pair.cpp"), "-o", str(d / "pair")], check=True,
                   capture_output=True, timeout=300)

    def run(line):
        out = subprocess.run([str(d / "pair")], input=line + "\n", check=True,
                             capture_output=True, text=True, timeout=300).stdout
        return [int(w, 16) for w in out.split()]

    return run


def _words(t: torch.Tensor) -> list:
    """(..., 1) int32 -> the uint32 words in memory order."""
    return [int(w) & 0xFFFFFFFF for w in t.reshape(-1).tolist()]


def _hex(words) -> str:
    return " ".join(f"{w:x}" for w in words)


def _affine(k: int):
    """k * G2 as ((2, 8, 1), (2, 8, 1)) Montgomery limbs."""
    x, y = cv.g2_to_affine(cv.g2_mul(cv.G2_GEN, k))
    return tuple(torch.stack([lb.ints_to_limbs([fq_to_mont(c)]) for c in coord])
                 for coord in (x, y))


def _lift(aff):
    one = jc.G2_PLAIN.const((1, 0), 1, "cpu")
    return (aff[0], aff[1], one)


def _points():
    """P with z != 1 (a doubling and a mixed add of lifted points), the
    identity, and lifted affine points: Q, -P, P made affine."""
    ops = jc.G2_PLAIN
    rng = np.random.default_rng(0)
    ka, kb, kq = (int(k) for k in rng.integers(1, 1 << 62, size=3))
    p = jc.pmadd(ops, jc.pdbl(ops, _lift(_affine(ka))), _affine(kb))
    px, py = jc.to_affine_plain(ops, p)
    return {"P": p, "O": jc.identity(ops, 1, "cpu"), "Q": _lift(_affine(kq)),
            "-P": _lift((px, ops.neg(py))), "P affine": _lift((px, py))}


CASES = [("P", 1), ("P", 5), ("P", 65), ("O", 2), ("Q", 3), ("-P", 1), ("P affine", 4)]


@pytest.mark.parametrize("case", CASES, ids=[f"{a} x{k}" for a, k in CASES])
def test_pair_doubling_equals_plain(pair_ops, case):
    name, k = case
    p = _points()[name]
    got = pair_ops(f"{k} {_hex(_words(torch.stack(p)))}")
    want = jc.pdbl_k_plain(jc.G2_PLAIN, p, k)
    assert got == _words(torch.stack(want))
    if name == "O":
        assert not any(_words(want[2]))  # the identity stays: z = 0
