// BN254 G1 / G2 projective point arithmetic for one thread.
//
// Complete a=0 short-Weierstrass formulas (Renes-Costello-Batina 2015,
// algorithms 7/8/9): the same formulas as icicle_snark_tpu/curve/jcurve.py
// padd/pmadd/pdbl and as the port's plain torch version in
// curve/jcurve.py, so every result equals the plain version's exactly.
// Affine (0, 0) is the identity for the mixed add (zkeys hold such points).
// p_add and p_dbl are __noinline__: inlined at every call site, a kernel
// holds several copies of a ~12-product formula and nvcc takes minutes.
// K4's hot loops, one addition each, use the force-inlined p_add_inl and
// p_madd (K4 is p_madd's only caller), so the operands stay in registers
// rather than passing through the call stack.
#pragma once
#include "field.cuh"

// ---------------------------------------------------------------- Fq (G1)
struct E1 {
  u32 v[8];
};

__device__ __forceinline__ E1 e_add(const E1& a, const E1& b) { E1 r; fadd<Fq>(r.v, a.v, b.v); return r; }
__device__ __forceinline__ E1 e_sub(const E1& a, const E1& b) { E1 r; fsub<Fq>(r.v, a.v, b.v); return r; }
__device__ __forceinline__ E1 e_mul(const E1& a, const E1& b) { E1 r; fmul<Fq>(r.v, a.v, b.v); return r; }
__device__ __forceinline__ E1 e_neg(const E1& a) { E1 r; fneg<Fq>(r.v, a.v); return r; }
__device__ __forceinline__ bool e_is_zero(const E1& a) { return fis_zero(a.v); }
// 9 * x = 8x + x (b3 = 3b = 9 for G1), as jcurve.FqOps.mul_b3
__device__ __forceinline__ E1 e_mul_b3(const E1& x) {
  E1 x2 = e_add(x, x);
  E1 x4 = e_add(x2, x2);
  E1 x8 = e_add(x4, x4);
  return e_add(x8, x);
}
__device__ __forceinline__ void e_set_zero(E1& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) a.v[k] = 0;
}
__device__ __forceinline__ void e_set_one(E1& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) a.v[k] = Fq::one(k);
}
// component c of lane i in a ([C,] 8, n) limb-major array
__device__ __forceinline__ void e_load(E1& a, const u32* base, long long n, long long i) { fload(a.v, base, n, i); }
__device__ __forceinline__ void e_store(u32* base, long long n, long long i, const E1& a) { fstore(base, n, i, a.v); }

// ---------------------------------------------------------------- Fq2 (G2), u^2 = -1
struct E2 {
  E1 c0, c1;
};

__device__ __forceinline__ E2 e_add(const E2& a, const E2& b) { return {e_add(a.c0, b.c0), e_add(a.c1, b.c1)}; }
__device__ __forceinline__ E2 e_sub(const E2& a, const E2& b) { return {e_sub(a.c0, b.c0), e_sub(a.c1, b.c1)}; }
__device__ __forceinline__ E2 e_neg(const E2& a) { return {e_neg(a.c0), e_neg(a.c1)}; }
// Karatsuba, as jcurve.Fq2Ops.mul_many
__device__ __forceinline__ E2 e_mul(const E2& a, const E2& b) {
  E1 t0 = e_mul(a.c0, b.c0);
  E1 t1 = e_mul(a.c1, b.c1);
  E1 t2 = e_mul(e_add(a.c0, a.c1), e_add(b.c0, b.c1));
  return {e_sub(t0, t1), e_sub(t2, e_add(t0, t1))};
}
__device__ __forceinline__ bool e_is_zero(const E2& a) { return e_is_zero(a.c0) && e_is_zero(a.c1); }
// b3 = 3 * b_G2 in Montgomery form
__device__ __forceinline__ E2 e_mul_b3(const E2& x) {
  const u32 B0[8] = {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                     0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u};
  const u32 B1[8] = {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                     0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};
  E2 b;
#pragma unroll
  for (int k = 0; k < 8; k++) { b.c0.v[k] = B0[k]; b.c1.v[k] = B1[k]; }
  return e_mul(b, x);
}
__device__ __forceinline__ void e_set_zero(E2& a) { e_set_zero(a.c0); e_set_zero(a.c1); }
__device__ __forceinline__ void e_set_one(E2& a) { e_set_one(a.c0); e_set_zero(a.c1); }
// Fq2 arrays are (2, 8, n): component c at c * 8 * n
__device__ __forceinline__ void e_load(E2& a, const u32* base, long long n, long long i) {
  fload(a.c0.v, base, n, i);
  fload(a.c1.v, base + 8 * n, n, i);
}
__device__ __forceinline__ void e_store(u32* base, long long n, long long i, const E2& a) {
  fstore(base, n, i, a.c0.v);
  fstore(base + 8 * n, n, i, a.c1.v);
}

// number of u32 words one coordinate occupies per lane
template <class E> struct ECoord { static constexpr int WORDS = 8; };
template <> struct ECoord<E2> { static constexpr int WORDS = 16; };

// ---------------------------------------------------------------- points
template <class E>
struct Pt {
  E x, y, z;
};

template <class E>
__device__ __forceinline__ Pt<E> p_identity() {
  Pt<E> r;
  e_set_zero(r.x);
  e_set_one(r.y);
  e_set_zero(r.z);
  return r;
}

// RCB15 alg 7 (jcurve.padd)
template <class E>
__device__ __forceinline__ Pt<E> p_add_inl(const Pt<E>& p, const Pt<E>& q) {
  E t0 = e_mul(p.x, q.x);
  E t1 = e_mul(p.y, q.y);
  E t2 = e_mul(p.z, q.z);
  E ta = e_mul(e_add(p.x, p.y), e_add(q.x, q.y));
  E tb = e_mul(e_add(p.y, p.z), e_add(q.y, q.z));
  E tc = e_mul(e_add(p.x, p.z), e_add(q.x, q.z));
  E t3 = e_sub(ta, e_add(t0, t1));
  E t4 = e_sub(tb, e_add(t1, t2));
  E t5 = e_sub(tc, e_add(t0, t2));
  E u = e_mul_b3(t2);
  E y3m = e_mul_b3(t5);
  E z3 = e_add(t1, u);
  E x3m = e_sub(t1, u);
  t0 = e_add(e_add(t0, t0), t0);
  Pt<E> r;
  r.x = e_sub(e_mul(t3, x3m), e_mul(t4, y3m));
  r.y = e_add(e_mul(x3m, z3), e_mul(t0, y3m));
  r.z = e_add(e_mul(t4, z3), e_mul(t3, t0));
  return r;
}

template <class E>
__device__ __noinline__ Pt<E> p_add(const Pt<E>& p, const Pt<E>& q) {
  return p_add_inl(p, q);
}

// RCB15 alg 8 (jcurve.pmadd): projective p + affine (qx, qy); (0,0) = identity
template <class E>
__device__ __forceinline__ Pt<E> p_madd(const Pt<E>& p, const E& qx, const E& qy) {
  if (e_is_zero(qx) && e_is_zero(qy)) return p;
  E t0 = e_mul(p.x, qx);
  E t1 = e_mul(p.y, qy);
  E ta = e_mul(e_add(p.x, p.y), e_add(qx, qy));
  E mxz = e_mul(qx, p.z);
  E myz = e_mul(qy, p.z);
  E u = e_mul_b3(p.z);
  E t3 = e_sub(ta, e_add(t0, t1));
  E t4 = e_add(mxz, p.x);
  E t5 = e_add(myz, p.y);
  E z3 = e_add(t1, u);
  E x3m = e_sub(t1, u);
  t0 = e_add(e_add(t0, t0), t0);
  E y3m = e_mul_b3(t4);
  Pt<E> r;
  r.x = e_sub(e_mul(t3, x3m), e_mul(t5, y3m));
  r.y = e_add(e_mul(x3m, z3), e_mul(t0, y3m));
  r.z = e_add(e_mul(t5, z3), e_mul(t3, t0));
  return r;
}

// RCB15 alg 9 (jcurve.pdbl)
template <class E>
__device__ __noinline__ Pt<E> p_dbl(const Pt<E>& p) {
  E t0 = e_mul(p.y, p.y);
  E t1 = e_mul(p.y, p.z);
  E t2 = e_mul(p.z, p.z);
  E txy = e_mul(p.x, p.y);
  E z3a = e_add(t0, t0);
  z3a = e_add(z3a, z3a);
  z3a = e_add(z3a, z3a);
  E t2b = e_mul_b3(t2);
  E y3s = e_add(t0, t2b);
  E t0b = e_sub(t0, e_add(e_add(t2b, t2b), t2b));
  E mxf = e_mul(t0b, txy);
  Pt<E> r;
  r.x = e_add(mxf, mxf);
  r.y = e_add(e_mul(t2b, z3a), e_mul(t0b, y3s));
  r.z = e_mul(t1, z3a);
  return r;
}

// Points stored as (3, coords, n): coordinate j at j * WORDS * n
template <class E>
__device__ __forceinline__ void p_store(u32* base, long long n, long long i, const Pt<E>& p) {
  constexpr int W = ECoord<E>::WORDS;
  e_store(base, n, i, p.x);
  e_store(base + (long long)W * n, n, i, p.y);
  e_store(base + 2LL * W * n, n, i, p.z);
}

template <class E>
__device__ __forceinline__ Pt<E> p_load(const u32* base, long long n, long long i) {
  constexpr int W = ECoord<E>::WORDS;
  Pt<E> p;
  e_load(p.x, base, n, i);
  e_load(p.y, base + (long long)W * n, n, i);
  e_load(p.z, base + 2LL * W * n, n, i);
  return p;
}

// One affine point of a lane-major record array (ops/msm.py point_records):
// G1 records are 16 words (x | y), G2 records 32 (x.c0 | x.c1 | y.c0 | y.c1),
// each read as 16-byte vectors (the array's base is 16-byte aligned).
template <int N>
__device__ __forceinline__ void rec_words(u32 (&w)[N], const u32* __restrict__ rec, long long lane) {
  const uint4* r = reinterpret_cast<const uint4*>(rec + lane * N);
#pragma unroll
  for (int k = 0; k < N / 4; k++) {
    uint4 v = __ldg(r + k);
    w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void rec_load(E1& x, E1& y, const u32* __restrict__ rec, long long lane) {
  u32 w[16];
  rec_words(w, rec, lane);
#pragma unroll
  for (int k = 0; k < 8; k++) { x.v[k] = w[k]; y.v[k] = w[8 + k]; }
}

__device__ __forceinline__ void rec_load(E2& x, E2& y, const u32* __restrict__ rec, long long lane) {
  u32 w[32];
  rec_words(w, rec, lane);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    x.c0.v[k] = w[k]; x.c1.v[k] = w[8 + k]; y.c0.v[k] = w[16 + k]; y.c1.v[k] = w[24 + k];
  }
}
