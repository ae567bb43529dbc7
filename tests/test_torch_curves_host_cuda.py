"""The arithmetic of the other curves' CUDA headers, run on the host: a small
program includes csrc/curve_n.cuh (with field_n.cuh, curve.cuh and
field.cuh) and is compiled by g++ against a stub `cuda_runtime.h` that
defines the CUDA qualifiers away; the headers are plain C++ otherwise. Its
field ops (K12's, K14's) on the five moduli and its point formulas (K13's:
the mixed add with (0, 0) as the identity, the complete add, doubling) on
the six point types are held against Python integers and curves/host.py.
Skips where no g++ is installed."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.curves import host
from icicle_snark_tpu_torch.curves.params import get_curve
from icicle_snark_tpu_torch.curves.device import KERNEL_FIELDS
from icicle_snark_tpu_torch.fields.limbs import FieldSpec

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

# reads "f <field> <op> a b" or "p <group> <op> point [point | affine]" lines of
# hex words, writes the result's words
PROGRAM = r"""
#include <cstdio>
#include <iostream>
#include <string>
#include "curve_n.cuh"
template <int N> void rd(u32* w) {
  for (int k = 0; k < N; k++) { std::string s; std::cin >> s; w[k] = (u32)std::stoul(s, nullptr, 16); }
}
template <int N> void wr(const u32* w) { for (int k = 0; k < N; k++) printf("%x ", w[k]); }
template <class F> void field_op(int op) {
  u32 a[F::N], b[F::N], r[F::N];
  rd<F::N>(a); rd<F::N>(b);
  if (op == 0) nmul<F>(r, a, b); else if (op == 1) nadd<F>(r, a, b);
  else if (op == 2) nsub<F>(r, a, b); else nneg<F>(r, a);
  wr<F::N>(r);
}
template <class E> void rd_e(E& e) { constexpr int W = ECoord<E>::WORDS; u32 w[W]; rd<W>(w); e_load(e, w, 1, 0); }
template <class E> void wr_e(const E& e) { constexpr int W = ECoord<E>::WORDS; u32 w[W]; e_store(w, 1, 0, e); wr<W>(w); }
template <class E> void point_op(int op) {
  Pt<E> p, q, r;
  rd_e(p.x); rd_e(p.y); rd_e(p.z);
  if (op == 0) { E qx, qy; rd_e(qx); rd_e(qy); r = p_madd(p, qx, qy); }
  else if (op == 1) { rd_e(q.x); rd_e(q.y); rd_e(q.z); r = p_add(p, q); }
  else r = p_dbl(p);
  wr_e(r.x); wr_e(r.y); wr_e(r.z);
}
int main() {
  std::string kind; int sel, op;
  while (std::cin >> kind >> sel >> op) {
    if (kind == "f") {
      switch (sel) {
        case 0: field_op<Bls377Fr>(op); break; case 1: field_op<Bls377Fq>(op); break;
        case 2: field_op<Bls381Fr>(op); break; case 3: field_op<Bls381Fq>(op); break;
        default: field_op<Bw6Fq>(op);
      }
    } else {
      switch (sel) {
        case 0: point_op<E377>(op); break; case 1: point_op<E377_2>(op); break;
        case 2: point_op<E381>(op); break; case 3: point_op<E381_2>(op); break;
        case 4: point_op<E761>(op); break; default: point_op<E761_2>(op);
      }
    }
    printf("\n");
  }
}
"""

# curve_n.cuh's types, in the program's order
GROUPS = [("bls12_377", False), ("bls12_377", True), ("bls12_381", False),
          ("bls12_381", True), ("bw6_761", False), ("bw6_761", True)]


@pytest.fixture(scope="module")
def host_ops(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the headers on the host")
    d = tmp_path_factory.mktemp("host_cuda")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "ops.cpp").write_text(PROGRAM)
    subprocess.run([gxx, "-std=c++17", "-O1", "-w", f"-I{d}", f"-I{CSRC}", str(d / "ops.cpp"),
                    "-o", str(d / "ops")], check=True, capture_output=True, timeout=300)

    def run(lines):
        out = subprocess.run([str(d / "ops")], input="\n".join(lines) + "\n", check=True,
                             capture_output=True, text=True, timeout=300).stdout
        return [[int(w, 16) for w in row.split()] for row in out.splitlines()]

    return run


def _hex(v: int, n: int) -> str:
    return " ".join(f"{(v >> (32 * k)) & 0xFFFFFFFF:x}" for k in range(n))


def _int(words) -> int:
    return sum(w << (32 * k) for k, w in enumerate(words))


@pytest.mark.parametrize("field", range(len(KERNEL_FIELDS)))
def test_field_ops_on_the_host(host_ops, field):
    curve, which = KERNEL_FIELDS[field]
    p = getattr(get_curve(curve), which)
    spec = FieldSpec(p, f"field {field}")
    n, rinv = spec.words, spec.rinv
    rng = np.random.default_rng(field)
    vals = [0, 1, p - 1, p - 2] + [int.from_bytes(rng.bytes(4 * n), "little") % p
                                   for _ in range(12)]
    cases = [(a, b, op) for a in vals for b in vals[::3] for op in range(4)]
    got = host_ops([f"f {field} {op} {_hex(a, n)} {_hex(b, n)}" for a, b, op in cases])
    want = [(a * b * rinv, a + b, a - b, -a)[op] % p for a, b, op in cases]
    assert [_int(g) for g in got] == want


@pytest.mark.parametrize("group", range(len(GROUPS)), ids=[f"{c}_{'g2' if g else 'g1'}"
                                                            for c, g in GROUPS])
def test_point_formulas_on_the_host(host_ops, group):
    name, g2 = GROUPS[group]
    p = get_curve(name)
    hc = host.g2_curve(p) if g2 else host.g1_curve(p)
    fq2 = g2 and p.fp2_nonresidue is not None
    spec = FieldSpec(p.q, "fq")
    n, r, q = spec.words, spec.r_mod, p.q

    def enc(v):
        return f"{_hex(v[0] * r % q, n)} {_hex(v[1] * r % q, n)}" if fq2 else _hex(v * r % q, n)

    def pt(point):
        return " ".join(enc(c) for c in point)

    rng = np.random.default_rng(group)
    gen = hc.from_affine(p.g2 if g2 else p.g1)
    a, b, c = (hc.mul_scalar(gen, int(k)) for k in rng.integers(1, 1 << 62, size=3))
    seven = (7, 0) if fq2 else 7
    a = tuple(hc.f.mul(v, seven) for v in a)  # a projective point with z != 1
    ident, aff = hc.zero_pt, hc.to_affine(c)
    zero = ((0, 0), (0, 0)) if fq2 else (0, 0)
    lines, want = [], []
    for x, qa in ((a, aff), (a, hc.to_affine(a)), (ident, aff), (a, zero)):
        lines.append(f"p {group} 0 {pt(x)} {enc(qa[0])} {enc(qa[1])}")
        want.append(hc.add(x, ident if qa == zero else hc.from_affine(qa)))
    for x, y in ((a, b), (a, a), (a, ident), (ident, ident)):
        lines.append(f"p {group} 1 {pt(x)} {pt(y)}")
        want.append(hc.add(x, y))
    for x in (a, ident):
        lines.append(f"p {group} 2 {pt(x)}")
        want.append(hc.dbl(x))
    rows = host_ops(lines)
    assert len(rows) == len(want)
    for words, w in zip(rows, want):
        vals = [_int(words[i * n:(i + 1) * n]) * spec.rinv % q for i in range(len(words) // n)]
        got = tuple(zip(vals[0::2], vals[1::2])) if fq2 else tuple(vals)
        assert hc.eq(got, w)
