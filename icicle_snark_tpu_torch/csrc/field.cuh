// BN254 Fr / Fq arithmetic on 8 x 32-bit limbs (little-endian), Montgomery
// form with R = 2^256 (the snarkjs on-disk radix). Shared by every kernel
// of the port. All values are canonical (< p) on input and output.
//
// Replaces the 16 x 16-bit limb graphs of icicle_snark_tpu/fields/limbs.py
// (mont_mul/_mont_mul_core, add_mod, sub_mod, neg_mod): the TPU VPU has no
// wide multiply, Hopper has 32 x 32 -> 64 integer products, so the CIOS
// product runs 8 rounds of 64-bit multiply-accumulate per limb.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

#define SNARK_NLIMB 8

// Field parameters. p(i) folds to an immediate inside unrolled loops.
struct Fr {
  static constexpr u32 N0 = 0xefffffffu;  // -p^-1 mod 2^32
  __device__ static __forceinline__ u32 p(int i) {
    switch (i) {
      case 0: return 0xf0000001u; case 1: return 0x43e1f593u;
      case 2: return 0x79b97091u; case 3: return 0x2833e848u;
      case 4: return 0x8181585du; case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u; default: return 0x30644e72u;
    }
  }
  // R mod r: the Montgomery form of 1
  __device__ static __forceinline__ u32 one(int i) {
    switch (i) {
      case 0: return 0x4ffffffbu; case 1: return 0xac96341cu;
      case 2: return 0x9f60cd29u; case 3: return 0x36fc7695u;
      case 4: return 0x7879462eu; case 5: return 0x666ea36fu;
      case 6: return 0x9a07df2fu; default: return 0x0e0a77c1u;
    }
  }
};

struct Fq {
  static constexpr u32 N0 = 0xe4866389u;
  __device__ static __forceinline__ u32 p(int i) {
    switch (i) {
      case 0: return 0xd87cfd47u; case 1: return 0x3c208c16u;
      case 2: return 0x6871ca8du; case 3: return 0x97816a91u;
      case 4: return 0x8181585du; case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u; default: return 0x30644e72u;
    }
  }
  // R mod q: the Montgomery form of 1
  __device__ static __forceinline__ u32 one(int i) {
    switch (i) {
      case 0: return 0xc58f0d9du; case 1: return 0xd35d438du;
      case 2: return 0xf5c70b3du; case 3: return 0x0a78eb28u;
      case 4: return 0x7879462cu; case 5: return 0x666ea36fu;
      case 6: return 0x9a07df2fu; default: return 0x0e0a77c1u;
    }
  }
};

// r = t - p if t >= p else t (t < 2p)
template <class F>
__device__ __forceinline__ void cond_sub_p(u32 r[8], const u32 t[8], u32 top) {
  u32 d[8];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 s = (u64)t[j] - F::p(j) - borrow;
    d[j] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  // t >= p iff the subtraction did not borrow (or t carried past 2^256)
  bool ge = (top != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = ge ? d[j] : t[j];
}

// CIOS Montgomery product: r = a * b * 2^-256 mod p.
template <class F>
__device__ __forceinline__ void fmul(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      u64 s = (u64)a[j] * b[i] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[8] + c;
    t[8] = (u32)s;
    t[9] = (u32)(s >> 32);
    u32 m = t[0] * F::N0;
    s = (u64)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (u64)m * F::p(j) + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[8] + c;
    t[7] = (u32)s;
    t[8] = t[9] + (u32)(s >> 32);
  }
  cond_sub_p<F>(r, t, t[8]);
}

template <class F>
__device__ __forceinline__ void fadd(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[8];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 s = (u64)a[j] + b[j] + c;
    t[j] = (u32)s;
    c = s >> 32;
  }
  cond_sub_p<F>(r, t, (u32)c);
}

template <class F>
__device__ __forceinline__ void fsub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[8];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 s = (u64)a[j] - b[j] - borrow;
    t[j] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  // underflow: add p back
  u32 mask = borrow ? 0xffffffffu : 0u;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u64 s = (u64)t[j] + (F::p(j) & mask) + c;
    r[j] = (u32)s;
    c = s >> 32;
  }
}

__device__ __forceinline__ bool fis_zero(const u32 a[8]) {
  u32 acc = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) acc |= a[j];
  return acc == 0;
}

template <class F>
__device__ __forceinline__ void fneg(u32 r[8], const u32 a[8]) {
  u32 z[8];
#pragma unroll
  for (int j = 0; j < 8; j++) z[j] = 0;
  if (fis_zero(a)) {
#pragma unroll
    for (int j = 0; j < 8; j++) r[j] = 0;
  } else {
    fsub<F>(r, z, a);
  }
}

// Limb-major global layout: limb k of lane i of an (8, n) block at k*n + i.
__device__ __forceinline__ void fload(u32 r[8], const u32* base, long long n, long long i) {
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = base[k * n + i];
}

__device__ __forceinline__ void fstore(u32* base, long long n, long long i, const u32 a[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) base[k * n + i] = a[k];
}
