"""K13's tree (csrc/msm_kernels_n.cuh) run on the host: a small program
includes the header and is compiled by g++ against a stub `cuda_runtime.h`
that defines the CUDA qualifiers away. It calls the tree kernel's
per-thread body (`msm_n_tree_thread`) for every thread of 32-thread blocks
that share one shared-memory buffer (the program table copied in, the
slots filled with garbage first), level by level as ops/msm.py launches
it, with the group's programs (ops/point_programs.py), on the segments'
sums and triangles of the plain segments stage, and holds the window sums
word for word against the plain reduce (`msm_reduce_n_plain`): bucket sums
of a case with a (0, 0) lane and negated digits, two window rows of 8
segments (three tree levels), for the six point types. Skips where no g++
is installed."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.curves import host
from icicle_snark_tpu_torch.curves.params import get_curve
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.ops import point_programs as pprog

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
template <class T> inline T __ldg(const T* p) { return *p; }
"""

# tree <field> <C> <dir> <windows> <groups> <n_seg> <scale>: dir/{table,meta,
# sums,tris}.bin -> dir/out.bin, the launches of ops/msm.py _msm_reduce_n
# after its segments stage
PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include "msm_kernels_n.cuh"

template <class T> static std::vector<T> rd(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<T> v(n / sizeof(T));
  if (n && fread(v.data(), 1, n, f) != (size_t)n) exit(3);
  fclose(f);
  return v;
}

template <class F, int C> void tree(const std::string& d, long long windows, long long groups,
                                    long long n, int scale) {
  std::vector<u32> table = rd<u32>(d + "/table.bin");
  std::vector<int> v = rd<int>(d + "/meta.bin");
  MsmNMeta m;
  for (int k = 0; k < MSMN_PROGRAMS; k++) { m.first[k] = v[k]; m.count[k] = v[MSMN_PROGRAMS + k]; }
  m.n_ops = v[2 * MSMN_PROGRAMS]; m.n_consts = v[2 * MSMN_PROGRAMS + 1]; m.n_slots = v[2 * MSMN_PROGRAMS + 2];
  // one block's shared memory, as the kernel fills it
  int nw = msm_n_table_words<F>(m);
  std::vector<u32> smem(nw + (size_t)m.n_slots * F::N * MSMN_THREADS, 0xdeadbeefu);
  memcpy(smem.data(), table.data(), 4 * nw);
  std::vector<u32> ms = rd<u32>(d + "/sums.bin"), ts = rd<u32>(d + "/tris.bin");
  long long rows = windows * groups, pt = 3 * C * F::N;
  std::vector<u32> out(pt * rows);
  while (n > 1) {
    std::vector<u32> m2(pt * rows * (n / 2)), t2(pt * rows * (n / 2));
    for (long long i = 0; i < 2 * rows * (n / 2); i++) {
      Slots<F, MSMN_THREADS> S{smem.data() + nw + i % MSMN_THREADS, smem.data(),
                               smem.data() + m.n_consts * F::N};
      msm_n_tree_thread<F, C>(S, m, i, out.data(), m2.data(), t2.data(), ms.data(), ts.data(),
                              windows, groups, n, scale);
    }
    ms.swap(m2); ts.swap(t2); n /= 2; scale = 0;
  }
  FILE* f = fopen((d + "/out.bin").c_str(), "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
}

int main(int argc, char** argv) {
  int field = atoi(argv[2]), c = atoi(argv[3]);
  std::string d = argv[4];
  long long w = atoll(argv[5]), g = atoll(argv[6]), n = atoll(argv[7]);
  int scale = atoi(argv[8]);
  if (field == 1 && c == 1) tree<Bls377Fq, 1>(d, w, g, n, scale);
  else if (field == 1) tree<Bls377Fq, 2>(d, w, g, n, scale);
  else if (field == 3 && c == 1) tree<Bls381Fq, 1>(d, w, g, n, scale);
  else if (field == 3) tree<Bls381Fq, 2>(d, w, g, n, scale);
  else tree<Bw6Fq, 1>(d, w, g, n, scale);
}
"""

GROUPS = [("bls12_377", False), ("bls12_377", True), ("bls12_381", False),
          ("bls12_381", True), ("bw6_761", False), ("bw6_761", True)]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the header on the host")
    d = tmp_path_factory.mktemp("msm_n_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k13.cpp").write_text(PROGRAM)
    subprocess.run([gxx, "-std=c++17", "-O1", "-w", f"-I{d}", f"-I{CSRC}", str(d / "k13.cpp"),
                    "-o", str(d / "k13")], check=True, capture_output=True, timeout=600)
    return d / "k13"


def _save(d: Path, **arrays):
    for name, a in arrays.items():
        np.ascontiguousarray(a).tofile(d / f"{name}.bin")


def _case(name: str, g2: bool, lanes: int = 40):
    """Distinct points G, 2G, ... (lane 5 the identity (0, 0)) and scalars
    1, 2 or 255 (at c = 8 the digit 1 negated, a carry into window 1)."""
    p = get_curve(name)
    grp = cdev.g2_group(name) if g2 else cdev.g1_group(name)
    hc = host.g2_curve(p) if g2 else host.g1_curve(p)
    gen = hc.from_affine(p.g2 if g2 else p.g1)
    pts, cur = [], gen
    for _ in range(lanes):
        pts.append(hc.to_affine(cur))
        cur = hc.add(cur, gen)
    pts[5] = None
    rng = np.random.default_rng(lanes)
    scalars = [int(v) for v in rng.choice([1, 1, 2, 255], size=lanes)]
    fr = cdev.curve_specs(name)[1]
    sc = lb.ints_to_limbs(scalars, "cpu", fr.words)
    rec = msm.point_records(cdev.affine_to_device(pts, grp.ops, "cpu"))
    return grp, sc, rec


@pytest.mark.parametrize("group", range(len(GROUPS)),
                         ids=[f"{c}_{'g2' if g else 'g1'}" for c, g in GROUPS])
def test_k13_tree_threads_match_plain_on_the_host(harness, tmp_path, group):
    name, g2 = GROUPS[group]
    grp, sc, rec = _case(name, g2)
    lanes, c = rec.shape[0], 8
    half = 1 << (c - 1)
    order, negs, ends = msm.sort_windows(sc, [lanes], c)
    assert bool(negs[0].any()) and bool(negs[0].logical_not().any())
    buckets = msm.msm_accumulate_plain(rec, order, negs, ends, 1, half, grp)[..., :2 * half]
    want = msm.msm_reduce_n_plain(grp.plain, buckets.contiguous(), 2, 1, half)
    seg, n_seg = msm.reduce_shape_n(half)
    assert n_seg == 8
    sums, tris = msm.msm_reduce_segments_plain(grp.plain, buckets, 2, half, seg)
    gp = pprog.group_programs(grp)
    _save(tmp_path, table=np.array(gp.table, dtype=np.int32),
          meta=np.array(gp.meta(), dtype=np.int32),
          sums=jc.point_stack(sums).numpy(), tris=jc.point_stack(tris).numpy())
    subprocess.run([str(harness), "tree", str(grp.ops.spec.field_id), str(gp.width),
                    str(tmp_path), "2", "1", str(n_seg), str(seg.bit_length() - 1)],
                   check=True, timeout=600)
    got = np.fromfile(tmp_path / "out.bin", dtype=np.int32).reshape(want.shape)
    assert np.array_equal(got, want.numpy())
