// BN254 G2 projective points split over a pair of neighbouring threads: the
// layout of K7 point_dbl_k on G2 (precompute.cu). The G1 kernels, K4 and K11
// keep curve.cuh's one-thread points.
//
// Why: a G2 point is 3 coordinates x 2 Fq components x 8 words = 48 words.
// With curve.cuh's formulas in one thread, K7's G2 doubling (__noinline__)
// passed the whole point through the call stack at every step (188
// registers, 192 B of stack). Here the even thread of a pair (lanes 2j,
// 2j + 1 of a warp) holds the c0 component of x, y and z and the odd thread
// c1: 24 words of point a thread, and the doubling is inlined.
//
// Fq2 (u^2 = -1) addition and subtraction are per component and need no
// exchange. The product is the schoolbook split: each thread swaps the other
// component of both operands with its partner (__shfl_xor_sync by 1, 8 words
// each) and does two Fq products, c0 = a0 b0 - a1 b1 on the even thread and
// c1 = a0 b1 + a1 b0 on the odd; the square takes one product a thread,
// c0 = (a0 + a1)(a0 - a1) and c1 = 2 a0 a1. Both threads run the same
// instructions on operands chosen by a select, so a pair never diverges. An
// Fq2 product is one canonical element, so these give the words of
// curve.cuh's Karatsuba: the doubling (RCB15 algorithm 9, as jcurve.pdbl)
// gives every projective word of the one-thread and plain versions. A
// doubling costs 32 Fq products a lane against Karatsuba's 27.
//
// K11's mixed add on the same pair (52 Fq products a lane against 39) ran
// 1.25x slower than its one-thread kernel on an H100 and was not kept
// (PERF.md, Findings).
//
// The shuffles name only the pair's two lanes, so a ragged last warp may
// have exited pairs. A block is a whole number of warps.
#pragma once
#include "curve.cuh"

// this thread's component (0 or 1) and the mask of its pair's two lanes
struct PairLane {
  bool odd;
  unsigned mask;
};

__device__ __forceinline__ PairLane pair_lane() {
  return {(threadIdx.x & 1) != 0, 3u << (threadIdx.x & 30)};
}

// the partner's component
__device__ __forceinline__ E1 h_other(const E1& a, PairLane pl) {
  E1 r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = __shfl_xor_sync(pl.mask, a.v[k], 1);
  return r;
}

__device__ __forceinline__ E1 h_sel(bool c, const E1& a, const E1& b) {
  E1 r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// the two Fq products of a component of a * b: the even thread a0 b0 - a1 b1,
// the odd a0 b1 + a1 b0, with a0, a1 both components of a and b_own, b_other
// this thread's and the partner's component of b
__device__ __forceinline__ E1 h_mul_parts(const E1& a0, const E1& a1, const E1& b_own,
                                          const E1& b_other, PairLane pl) {
  E1 t1 = e_mul(a0, b_own);
  E1 t2 = e_mul(a1, b_other);
  return h_sel(pl.odd, e_add(t1, t2), e_sub(t1, t2));
}

__device__ __forceinline__ E1 h_mul(const E1& a, const E1& b, PairLane pl) {
  E1 ao = h_other(a, pl), bo = h_other(b, pl);
  return h_mul_parts(h_sel(pl.odd, ao, a), h_sel(pl.odd, a, ao), b, bo, pl);
}

// a^2: the even thread (a0 + a1)(a0 - a1), the odd 2 a0 a1
__device__ __forceinline__ E1 h_sqr(const E1& a, PairLane pl) {
  E1 ao = h_other(a, pl);
  E1 a0 = h_sel(pl.odd, ao, a), a1 = h_sel(pl.odd, a, ao);
  E1 m = e_mul(h_sel(pl.odd, a0, e_add(a0, a1)), h_sel(pl.odd, a1, e_sub(a0, a1)));
  return h_sel(pl.odd, e_add(m, m), m);
}

// x * b3, b3 = 3 b_G2 in Montgomery form (curve.cuh e_mul_b3)
__device__ __forceinline__ E1 h_mul_b3(const E1& x, PairLane pl) {
  const u32 B0[8] = {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                     0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u};
  const u32 B1[8] = {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                     0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};
  E1 b_own, b_other;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    b_own.v[k] = pl.odd ? B1[k] : B0[k];
    b_other.v[k] = pl.odd ? B0[k] : B1[k];
  }
  E1 xo = h_other(x, pl);
  return h_mul_parts(h_sel(pl.odd, xo, x), h_sel(pl.odd, x, xo), b_own, b_other, pl);
}

// RCB15 alg 9 (curve.cuh p_dbl)
__device__ __forceinline__ Pt<E1> pair_dbl(const Pt<E1>& p, PairLane pl) {
  E1 t0 = h_sqr(p.y, pl);
  E1 t1 = h_mul(p.y, p.z, pl);
  E1 t2 = h_sqr(p.z, pl);
  E1 txy = h_mul(p.x, p.y, pl);
  E1 z3a = e_add(t0, t0);
  z3a = e_add(z3a, z3a);
  z3a = e_add(z3a, z3a);
  E1 t2b = h_mul_b3(t2, pl);
  E1 y3s = e_add(t0, t2b);
  E1 t0b = e_sub(t0, e_add(e_add(t2b, t2b), t2b));
  E1 mxf = h_mul(t0b, txy, pl);
  Pt<E1> r;
  r.x = e_add(mxf, mxf);
  r.y = e_add(h_mul(t2b, z3a, pl), h_mul(t0b, y3s, pl));
  r.z = h_mul(t1, z3a, pl);
  return r;
}

// this thread's components of lane i of a (3, 2, 8, n) point array:
// coordinate j, component c at (2 j + c) * 8 * n
__device__ __forceinline__ Pt<E1> pair_load(const u32* base, long long n, long long i,
                                            PairLane pl) {
  const u32* b = base + (pl.odd ? 8 * n : 0);
  Pt<E1> p;
  e_load(p.x, b, n, i);
  e_load(p.y, b + 16 * n, n, i);
  e_load(p.z, b + 32 * n, n, i);
  return p;
}

__device__ __forceinline__ void pair_store(u32* base, long long n, long long i, PairLane pl,
                                           const Pt<E1>& p) {
  u32* b = base + (pl.odd ? 8 * n : 0);
  e_store(b, n, i, p.x);
  e_store(b + 16 * n, n, i, p.y);
  e_store(b + 32 * n, n, i, p.z);
}
