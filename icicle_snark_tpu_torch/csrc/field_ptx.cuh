// BN254 Fr arithmetic as PTX carry chains, with lazy reduction: the field
// layer of K2 (r1cs.cu) and K5 (ntt_block.cu). field.cuh stays the layer of
// the other kernels.
//
// Replaces, for these two kernels, icicle_snark_tpu/fields/limbs.py
// mont_mul/_mont_mul_core (:375/:394), add_mod (:269) and sub_mod (:293)
// (16-bit limb graphs on the TPU's VPU). field.cuh's fmul spells each
// 32 x 32 multiply-add as a 64-bit C product plus separate adds and carry
// extraction, and every product, sum and difference ends canonical. Here a
// row of eight multiply-adds is ONE carry chain (mad.lo.cc / madc.lo.cc /
// madc.hi.cc / addc, as ICICLE and sppark write it), and values stay lazy.
//
// Lazy bounds (r < 2^254, so 4r < 2^256 = R; r / R = 0.189):
//   fr_mul(a, b):  a * b < R * r (for example a, b < 2r)  ->  out < 2r.
//     CIOS keeps t < a + r after each round, so the running sum of a round,
//     t + a * b_i + m * r, is below 5r * 2^32 < 2^288 for any a < 4r, b < R:
//     nine words hold it and the last addc / madc.hi carries out nothing.
//     The result is (a b + M r) / R < a b / R + r < 2r.
//   fr_add2(a, b): a, b < 2r  ->  out < 2r (a + b < 4r < R, then - 2r if >= 2r).
//   fr_sub2(a, b): a, b < 2r  ->  out < 2r (a - b, then + 2r on a borrow).
//   fr_canon(a):   a < 2r     ->  out < r (- r if >= r).
// Inside a pass every value stays in [0, 2r); a pass makes its values
// canonical only when it writes them to global memory, so its output is the
// canonical (unique) representative of the same residue that the plain
// version, canonical after every operation, computes: equal word for word.
// tests/test_torch_coset.py models these chains word by word on
// Python integers and checks the bounds.
#pragma once
#include "field.cuh"

#define FR_N0 0xefffffffu  // -r^-1 mod 2^32

// r and 2r, least significant word first
__device__ __forceinline__ u32 fr_p(int i) { return Fr::p(i); }
__device__ __forceinline__ u32 fr_2p(int i) {
  switch (i) {
    case 0: return 0xe0000002u; case 1: return 0x87c3eb27u;
    case 2: return 0xf372e122u; case 3: return 0x5067d090u;
    case 4: return 0x0302b0bau; case 5: return 0x70a08b6du;
    case 6: return 0xc2634053u; default: return 0x60c89ce5u;
  }
}

// t[0..7] += lo(a[j] * b), the carry out of t[7] into t[8]
__device__ __forceinline__ void mac_lo(u32 t[9], const u32 a[8], u32 b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b));
}

// t[1..8] += hi(a[j] * b); the bounds above leave no carry out of t[8]
__device__ __forceinline__ void mac_hi(u32 t[9], const u32 a[8], u32 b) {
  asm("mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
      "madc.hi.u32 %7, %15, %16, %7;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b));
}

// CIOS Montgomery product r = a * b * 2^-256 mod r, lazy (bounds above).
__device__ __forceinline__ void fr_mul(u32 out[8], const u32 a[8], const u32 b[8]) {
  u32 p[8];
#pragma unroll
  for (int j = 0; j < 8; j++) p[j] = fr_p(j);
  u32 t[9];
#pragma unroll
  for (int j = 0; j < 9; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    mac_lo(t, a, b[i]);
    mac_hi(t, a, b[i]);
    u32 m = t[0] * FR_N0;
    mac_lo(t, p, m);  // t[0] becomes 0
    mac_hi(t, p, m);
#pragma unroll
    for (int j = 0; j < 8; j++) t[j] = t[j + 1];
    t[8] = 0;
  }
#pragma unroll
  for (int j = 0; j < 8; j++) out[j] = t[j];
}

// out = s - q if s >= q else s, for s < 2q (q = r or 2r, words given)
__device__ __forceinline__ void sub_if_ge(u32 out[8], const u32 s[8], const u32 q[8]) {
  u32 d[8], borrow = 0;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %8, %8;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "+r"(borrow)
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]), "r"(s[7]),
        "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]), "r"(q[7]));
  // borrow is all ones when s < q
#pragma unroll
  for (int j = 0; j < 8; j++) out[j] = borrow ? s[j] : d[j];
}

__device__ __forceinline__ void fr_canon(u32 out[8], const u32 a[8]) {
  u32 q[8];
#pragma unroll
  for (int j = 0; j < 8; j++) q[j] = fr_p(j);
  sub_if_ge(out, a, q);
}

__device__ __forceinline__ void fr_add2(u32 out[8], const u32 a[8], const u32 b[8]) {
  u32 s[8], q[8];
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]),
        "=r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
#pragma unroll
  for (int j = 0; j < 8; j++) q[j] = fr_2p(j);
  sub_if_ge(out, s, q);
}

__device__ __forceinline__ void fr_sub2(u32 out[8], const u32 a[8], const u32 b[8]) {
  u32 d[8], borrow = 0;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %8, %8;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "+r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  // on a borrow add 2r back (the carry out of the top word cancels the borrow)
  u32 q[8];
#pragma unroll
  for (int j = 0; j < 8; j++) q[j] = fr_2p(j) & borrow;
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]), "r"(q[7]));
#pragma unroll
  for (int j = 0; j < 8; j++) out[j] = d[j];
}
