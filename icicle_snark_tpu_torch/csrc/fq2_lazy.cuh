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
//   add, sub, canon: those of fq_lazy.cuh on each component.
// tests/test_torch_fq_lazy.py models these steps on Python integers and
// checks every bound.
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
