// Lazy BN254 Fq2 arithmetic (u^2 = -1) for one thread: E2's operations of
// the lazy layer (fq_lazy.cuh), for K4's G2 loops (msm_kernels.cuh). Every
// component stays in [0, 2q), canonical only at the store.
//
// Replaces, for those loops, curve.cuh's Fq2 operations (jcurve.Fq2Ops),
// whose Karatsuba product makes each of its three Fq products and its two
// sums and two differences canonical. Here:
//   fq2_lz_mul(a, b):  a, b with components < 2q -> components < 2q: the
//     same Karatsuba on fq_lz_mul, fq_lz_add and fq_lz_sub (three
//     reductions, no final subtraction). A product that reduces twice (two
//     512-bit values, one reduction each) needs 32 more live words and
//     spilled 192 B in K4's G2 level 0 against the canonical 60 B (PERF.md,
//     the K4 rows of the kernel table), so it is not used.
//   b3 x:  the same product with b3 = 3 b_G2 (curve.cuh e_mul_b3).
//   fq2_lz_sqr(a):  (a0 + a1)(a0 - a1) and 2 a0 a1, two Fq products.
//   add, sub, canon, is_zero: those of fq_lazy.cuh on each component.
// tests/test_torch_fq_lazy.py models these steps on Python integers and
// checks every bound.
//
// K4's G2 level 0 (msm_kernels.cuh) keeps its running sum in Jacobian
// coordinates (X / Z^2, Y / Z^3) over these operations: the incomplete
// mixed add madd-2007-bl, 7 Fq2 products and 4 squarings (29 Fq products),
// against RCB15 algorithm 8's 13 Fq2 products, two of them by b3 (39), and
// fewer Fq2 values live at once; the first add after a load, whose Z is 1,
// as mmadd-2007-bl (16 Fq products, the same values; 42.8 -> 38.1 ms on
// complex-1600k's G2 level 0). Its exceptions are branched: a sum at the
// identity (Z = 0 mod q) takes the record as (x, y, 1); the record equal to
// the sum (H = r = 0) takes the doubling dbl-2009-l; the record equal to
// minus the sum (H = 0, r != 0) gives Z3 = 0, the identity. The store writes
// the homogeneous projective (X Z, Y, Z^3), canonical, or (0, 1, 0), so the
// fold levels and the reduce read what they read from RCB15's sums: the
// same affine points, other words (ops/msm.py msm_bucket_sums_plain mirrors
// them, jcurve.jmadd, jdbl, jac_to_proj).
#pragma once
#include "fq_lazy.cuh"

__device__ __forceinline__ E2 fq2_lz_mul(const E2& a, const E2& b) {
  E1 t0 = fq_lz_mul(a.c0, b.c0);
  E1 t1 = fq_lz_mul(a.c1, b.c1);
  E1 t2 = fq_lz_mul(fq_lz_add(a.c0, a.c1), fq_lz_add(b.c0, b.c1));
  return {fq_lz_sub(t0, t1), fq_lz_sub(t2, fq_lz_add(t0, t1))};
}

// b3 = 3 b_G2 in Montgomery form
__device__ __forceinline__ E2 fq2_b3() {
  const u32 B0[8] = {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                     0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u};
  const u32 B1[8] = {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                     0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};
  E2 b;
#pragma unroll
  for (int k = 0; k < 8; k++) { b.c0.v[k] = B0[k]; b.c1.v[k] = B1[k]; }
  return b;
}

__device__ __forceinline__ E2 lz_mul(const E2& a, const E2& b) { return fq2_lz_mul(a, b); }
__device__ __forceinline__ E2 lz_add(const E2& a, const E2& b) {
  return {fq_lz_add(a.c0, b.c0), fq_lz_add(a.c1, b.c1)};
}
__device__ __forceinline__ E2 lz_sub(const E2& a, const E2& b) {
  return {fq_lz_sub(a.c0, b.c0), fq_lz_sub(a.c1, b.c1)};
}
__device__ __forceinline__ E2 lz_mul_b3(const E2& x) { return fq2_lz_mul(fq2_b3(), x); }
__device__ __forceinline__ E2 lz_canon(const E2& a) { return {fq_lz_canon(a.c0), fq_lz_canon(a.c1)}; }
__device__ __forceinline__ bool lz_is_zero(const E2& a) {
  return fq_lz_is_zero(a.c0) && fq_lz_is_zero(a.c1);
}

__device__ __forceinline__ E2 fq2_lz_sqr(const E2& a) {
  E1 t = fq_lz_mul(a.c0, a.c1);
  return {fq_lz_mul(fq_lz_add(a.c0, a.c1), fq_lz_sub(a.c0, a.c1)), fq_lz_add(t, t)};
}

// ---------------------------------------------------------------- Jacobian G2

// 2p, p = (X, Y, Z) Jacobian (dbl-2009-l, a = 0)
__device__ __forceinline__ Pt<E2> lz_jdbl(const Pt<E2>& p) {
  Pt<E2> o;
  E2 yz = lz_mul(p.y, p.z);
  o.z = lz_add(yz, yz);
  E2 a = fq2_lz_sqr(p.x);
  E2 b = fq2_lz_sqr(p.y);
  E2 c = fq2_lz_sqr(b);
  E2 d = lz_sub(lz_sub(fq2_lz_sqr(lz_add(p.x, b)), a), c);
  d = lz_add(d, d);
  E2 e = lz_add(lz_add(a, a), a);
  o.x = lz_sub(fq2_lz_sqr(e), lz_add(d, d));
  E2 c8 = lz_add(c, c);
  c8 = lz_add(c8, c8);
  c8 = lz_add(c8, c8);
  o.y = lz_sub(lz_mul(e, lz_sub(d, o.x)), c8);
  return o;
}

// p + (x2, y2) (madd-2007-bl, a = 0): p Jacobian with Z != 0 mod q, (x2, y2)
// affine and not the identity; z1: Z is the 1 a load set, so Z1Z1 = 1, U2 =
// x2, S2 = y2 and Z3 = 2H (mmadd-2007-bl, 13 Fq products fewer). Z3 is
// formed right after HH, so Z and Z1Z1 die before the products of X3 and Y3.
__device__ __forceinline__ Pt<E2> lz_jmadd(const Pt<E2>& p, bool z1, const E2& x2,
                                          const E2& y2) {
  E2 zz, u2 = x2, s2 = y2;
  if (!z1) {
    zz = fq2_lz_sqr(p.z);
    u2 = lz_mul(x2, zz);
    s2 = lz_mul(y2, lz_mul(p.z, zz));
  }
  E2 h = lz_sub(u2, p.x);
  E2 r = lz_sub(s2, p.y);
  r = lz_add(r, r);
  if (lz_is_zero(h) && lz_is_zero(r)) return lz_jdbl(p);
  E2 hh = fq2_lz_sqr(h);
  Pt<E2> o;
  o.z = z1 ? lz_add(h, h) : lz_sub(lz_sub(fq2_lz_sqr(lz_add(p.z, h)), zz), hh);
  E2 i = lz_add(hh, hh);
  i = lz_add(i, i);
  E2 j = lz_mul(h, i);
  E2 v = lz_mul(p.x, i);
  o.x = lz_sub(lz_sub(fq2_lz_sqr(r), j), lz_add(v, v));
  E2 yj = lz_mul(p.y, j);
  o.y = lz_sub(lz_mul(r, lz_sub(v, o.x)), lz_add(yj, yj));
  return o;
}

// one step of the level-0 loop: a (0, 0) record passes, a sum at the
// identity takes the record (z1 set: its Z is 1), else the Jacobian mixed add
__device__ __forceinline__ Pt<E2> lz_jstep(const Pt<E2>& p, bool& z1, const E2& x2,
                                          const E2& y2) {
  if (e_is_zero(x2) && e_is_zero(y2)) return p;
  if (lz_is_zero(p.z)) {
    Pt<E2> r{x2, y2, {}};
    e_set_one(r.z);
    z1 = true;
    return r;
  }
  bool one = z1;
  z1 = false;
  return lz_jmadd(p, one, x2, y2);
}

// (X Z, Y, Z^3) canonical, or the identity (0, 1, 0) where Z = 0 mod q
__device__ __forceinline__ Pt<E2> lz_jac_to_proj(const Pt<E2>& p) {
  if (lz_is_zero(p.z)) return p_identity<E2>();
  E2 zz = fq2_lz_sqr(p.z);
  return lz_canon(Pt<E2>{lz_mul(p.x, p.z), p.y, lz_mul(zz, p.z)});
}
