// Lazy BN254 Fq arithmetic for one thread, the lazy point formulas over it,
// and K11's G1 window loop (fixed_base.cu). K4's BN254 loops (msm_kernels.cuh)
// run the same formulas, at G2 over fq2_lazy.cuh. field.cuh and curve.cuh
// stay the layer of every other kernel, K11's G2 kernel included.
//
// Replaces, for those loops, icicle_snark_tpu/fields/limbs.py mont_mul,
// add_mod and sub_mod (:375/:269/:293) as jcurve.pmadd and jcurve.padd use
// them in icicle_snark_tpu/setup/fast_setup.py _fixed_base_msm (:81) and
// icicle_snark_tpu/ops/msm.py _window_bucket_prefixes (:609). field.cuh ends
// every product, sum and difference canonical (a conditional subtraction of
// q: an 8-word subtract and 8 selects), and curve.cuh forms 9x as four
// canonical doublings and sums: together 15-20 % of the instructions of a
// mixed add. Here every value of the loop stays in [0, 2q):
//   fq_lz_mul(a, b):  a, b < 2q -> out < 2q. field.cuh's CIOS in 64-bit C
//     (not PTX carry chains: ptxas lowers those to more instructions) without
//     its final subtraction. The running sum stays below a + q < 3q < R, and
//     the result is below a b / R + q < (4q / R) q + q < 1.76 q, since
//     q < 2^254 gives 4q < R = 2^256 (q / R = 0.189).
//   fq_lz_add(a, b):  a, b < 2q -> out < 2q (a + b < 4q < R, then - 2q if >= 2q).
//   fq_lz_sub(a, b):  a, b < 2q -> out < 2q (a - b, then + 2q on a borrow).
//   fq_lz_mul9(x):    x < 2q -> out < 2q. t = 9x in nine words (t < 18q, its
//     top word at most 3); k = floor(t_hi / (q_7 + 1)), t_hi the top two
//     words (t >> 224) and q_7 q's top word, is at most floor(t / q), so
//     t - k q >= 0, and t - k q < q + 18 * 2^224 < 2q.
//   fq_lz_canon(a):   a < 2q -> out < q.
// Each operation computes the residue its canonical counterpart does, and
// a loop makes each coordinate canonical when it stores it, so the
// projective words equal those of curve.cuh's formulas and of the plain
// versions (setup/fast_setup.py fixed_base_msm_plain, ops/msm.py
// msm_bucket_sums_plain, msm_reduce_segments_plain) word for word. Nothing
// branches on a lazy value: the complete formulas need no such branch.
// tests/test_torch_fq_lazy.py models these steps on Python integers and
// checks every bound; tests/test_torch_setup_host_cuda.py and
// tests/test_torch_msm_host_cuda.py run the loops on the host.
#pragma once
#include "curve.cuh"

// 2q, least significant word first
__device__ __forceinline__ u32 fq_2p(int i) {
  switch (i) {
    case 0: return 0xb0f9fa8eu; case 1: return 0x7841182du;
    case 2: return 0xd0e3951au; case 3: return 0x2f02d522u;
    case 4: return 0x0302b0bbu; case 5: return 0x70a08b6du;
    case 6: return 0xc2634053u; default: return 0x60c89ce5u;
  }
}

__device__ __forceinline__ E1 fq_lz_mul(const E1& a, const E1& b) {
  u32 t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      u64 s = (u64)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[8] + c;
    t[8] = (u32)s;
    t[9] = (u32)(s >> 32);
    u32 m = t[0] * Fq::N0;
    s = (u64)m * Fq::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (u64)m * Fq::p(j) + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[8] + c;
    t[7] = (u32)s;
    t[8] = t[9] + (u32)(s >> 32);
  }
  E1 r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = t[j];
  return r;
}

__device__ __forceinline__ E1 fq_lz_add(const E1& a, const E1& b) {
  u32 s[8], d[8];
  u64 c = 0, borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 x = (u64)a.v[j] + b.v[j] + c;
    s[j] = (u32)x;
    c = x >> 32;
  }
  // s < 4q < R: no carry out; s - 2q if s >= 2q
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 x = (u64)s[j] - fq_2p(j) - borrow;
    d[j] = (u32)x;
    borrow = (x >> 32) & 1;
  }
  E1 r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = borrow ? s[j] : d[j];
  return r;
}

__device__ __forceinline__ E1 fq_lz_sub(const E1& a, const E1& b) {
  u32 d[8];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 x = (u64)a.v[j] - b.v[j] - borrow;
    d[j] = (u32)x;
    borrow = (x >> 32) & 1;
  }
  // on a borrow add 2q back (the carry out of the top word cancels the borrow)
  u32 mask = borrow ? 0xffffffffu : 0u;
  E1 r;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 x = (u64)d[j] + (fq_2p(j) & mask) + c;
    r.v[j] = (u32)x;
    c = x >> 32;
  }
  return r;
}

// 9x (b3 = 3b = 9 for G1, as jcurve.FqOps.mul_b3)
__device__ __forceinline__ E1 fq_lz_mul9(const E1& x) {
  u32 t[9];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 s = (u64)x.v[j] * 9u + c;
    t[j] = (u32)s;
    c = s >> 32;
  }
  t[8] = (u32)c;
  u32 k = (u32)((((u64)t[8] << 32) | t[7]) / ((u64)Fq::p(7) + 1));
  E1 r;
  u64 borrow = 0, kc = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 kq = (u64)k * Fq::p(j) + kc;
    kc = kq >> 32;
    u64 s = (u64)t[j] - (u32)kq - borrow;
    r.v[j] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  return r;  // the ninth word of t - k q is 0
}

__device__ __forceinline__ E1 fq_lz_canon(const E1& a) {
  E1 r;
  cond_sub_p<Fq>(r.v, a.v, 0);
  return r;
}

// The lazy operations by element type, for the formulas below (fq2_lazy.cuh
// adds E2's)
__device__ __forceinline__ E1 lz_mul(const E1& a, const E1& b) { return fq_lz_mul(a, b); }
__device__ __forceinline__ E1 lz_add(const E1& a, const E1& b) { return fq_lz_add(a, b); }
__device__ __forceinline__ E1 lz_sub(const E1& a, const E1& b) { return fq_lz_sub(a, b); }
__device__ __forceinline__ E1 lz_mul_b3(const E1& x) { return fq_lz_mul9(x); }
__device__ __forceinline__ E1 lz_canon(const E1& a) { return fq_lz_canon(a); }

// RCB15 algorithm 8 (jcurve.pmadd, curve.cuh p_madd) in lazy arithmetic:
// p + (qx, qy), p's coordinates in [0, 2q), (qx, qy) in [0, 2q) and not the
// identity (0, 0).
template <class E>
__device__ __forceinline__ Pt<E> lz_madd(const Pt<E>& p, const E& qx, const E& qy) {
  E t0 = lz_mul(p.x, qx);
  E t1 = lz_mul(p.y, qy);
  E ta = lz_mul(lz_add(p.x, p.y), lz_add(qx, qy));
  E mxz = lz_mul(qx, p.z);
  E myz = lz_mul(qy, p.z);
  E u = lz_mul_b3(p.z);
  E t3 = lz_sub(ta, lz_add(t0, t1));
  E t4 = lz_add(mxz, p.x);
  E t5 = lz_add(myz, p.y);
  E z3 = lz_add(t1, u);
  E x3m = lz_sub(t1, u);
  t0 = lz_add(lz_add(t0, t0), t0);
  E y3m = lz_mul_b3(t4);
  Pt<E> r;
  r.x = lz_sub(lz_mul(t3, x3m), lz_mul(t5, y3m));
  r.y = lz_add(lz_mul(x3m, z3), lz_mul(t0, y3m));
  r.z = lz_add(lz_mul(t5, z3), lz_mul(t3, t0));
  return r;
}

// RCB15 algorithm 7 (jcurve.padd, curve.cuh p_add_inl) in lazy arithmetic:
// p + q, every coordinate in [0, 2q)
template <class E>
__device__ __forceinline__ Pt<E> lz_padd(const Pt<E>& p, const Pt<E>& q) {
  E t0 = lz_mul(p.x, q.x);
  E t1 = lz_mul(p.y, q.y);
  E t2 = lz_mul(p.z, q.z);
  E ta = lz_mul(lz_add(p.x, p.y), lz_add(q.x, q.y));
  E tb = lz_mul(lz_add(p.y, p.z), lz_add(q.y, q.z));
  E tc = lz_mul(lz_add(p.x, p.z), lz_add(q.x, q.z));
  E t3 = lz_sub(ta, lz_add(t0, t1));
  E t4 = lz_sub(tb, lz_add(t1, t2));
  E t5 = lz_sub(tc, lz_add(t0, t2));
  E u = lz_mul_b3(t2);
  E y3m = lz_mul_b3(t5);
  E z3 = lz_add(t1, u);
  E x3m = lz_sub(t1, u);
  t0 = lz_add(lz_add(t0, t0), t0);
  Pt<E> r;
  r.x = lz_sub(lz_mul(t3, x3m), lz_mul(t4, y3m));
  r.y = lz_add(lz_mul(x3m, z3), lz_mul(t0, y3m));
  r.z = lz_add(lz_mul(t4, z3), lz_mul(t3, t0));
  return r;
}

// every coordinate canonical, for the store
template <class E>
__device__ __forceinline__ Pt<E> lz_canon(const Pt<E>& p) {
  return {lz_canon(p.x), lz_canon(p.y), lz_canon(p.z)};
}

// 16 bytes global -> shared by cp.async; built for the host (the tests), a
// plain copy
__device__ __forceinline__ void stage16(u32* dst, const u32* src) {
#ifdef __CUDA_ARCH__
  unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
#else
  for (int k = 0; k < 4; k++) dst[k] = src[k];
#endif
}

__device__ __forceinline__ void stage_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// every group but the newest has landed
__device__ __forceinline__ void stage_wait_prior() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

// Lane i of K11 on G1, thread t of the block's nt: 32 windows of 8 bits, low
// window first. The block's threads walk the windows in step: each window's
// 256 records T[w][d] (16 KB) are staged into shared memory by cp.async one
// window ahead (buf: 2 x 4096 words), and a lane reads its record there. A
// zero digit skips its add, as the identity passes through pmadd. Lanes past
// n take part in the staging and the barriers.
__device__ __forceinline__ void fixed_base_g1_lane(u32* __restrict__ out,
                                                   const u32* __restrict__ scalars,
                                                   const u32* __restrict__ table, long long n,
                                                   long long i, int t, int nt, u32* buf) {
  u32 s[8];
#pragma unroll
  for (int k = 0; k < 8; k++) s[k] = 0;
  if (i < n) fload(s, scalars, n, i);
  Pt<E1> acc = p_identity<E1>();
  for (int c = t; c < 1024; c += nt) stage16(buf + 4 * c, table + 4 * c);
  stage_commit();
#pragma unroll 1
  for (int w = 0; w < 32; w++) {
    if (w < 31) {
      u32* nb = buf + ((w + 1) & 1) * 4096;
      const u32* src = table + (long long)(w + 1) * 4096;
      for (int c = t; c < 1024; c += nt) stage16(nb + 4 * c, src + 4 * c);
    }
    stage_commit();  // empty at w = 31
    stage_wait_prior();
    __syncthreads();  // window w's records are in buf[w & 1]
    u32 d = s[0] & 0xffu;
#pragma unroll
    for (int k = 0; k < 7; k++) s[k] = (s[k] >> 8) | (s[k + 1] << 24);
    s[7] >>= 8;
    if (d) {
      const uint4* r = reinterpret_cast<const uint4*>(buf + (w & 1) * 4096 + d * 16);
      u32 wd[16];
#pragma unroll
      for (int k = 0; k < 4; k++) {
        uint4 v = r[k];
        wd[4 * k] = v.x; wd[4 * k + 1] = v.y; wd[4 * k + 2] = v.z; wd[4 * k + 3] = v.w;
      }
      E1 x, y;
#pragma unroll
      for (int k = 0; k < 8; k++) { x.v[k] = wd[k]; y.v[k] = wd[8 + k]; }
      acc = lz_madd(acc, x, y);
    }
    __syncthreads();  // buf[w & 1] is read before window w + 2 is staged into it
  }
  if (i >= n) return;
  acc.x = fq_lz_canon(acc.x);
  acc.y = fq_lz_canon(acc.y);
  acc.z = fq_lz_canon(acc.z);
  p_store(out, n, i, acc);
}
