// Montgomery arithmetic over F::N 32-bit words for the fields of the other
// curves: the scalar and base fields of bls12-377 and bls12-381 and the base
// field of bw6-761 (whose scalar field is bls12-377's base field). Shared by
// K12 (field_vec_n.cu), K13 (curve_n.cuh, msm_*.cu) and K14 (ntt_n.cu).
// field.cuh (BN254 on 8 words) is separate and unchanged.
//
// Replaces the 16-bit limb graphs of icicle_snark_tpu/fields/limbs.py
// (mont_mul, add_mod, sub_mod, neg_mod) at the FieldSpec widths of
// icicle_snark_tpu/curves/device.py: 16, 24 and 48 limbs of 16 bits there,
// 8, 12 and 24 words of 32 bits here, with the same R = 2^(32 N) (the JAX
// FieldSpec's R = 2^(16 nlimb), nlimb even), so every Montgomery value is
// the same integer. 2p < R for every field, the bound the canonical CIOS
// product below needs. All values are canonical (< p) on input and output.
//
// One traits struct a modulus, in field.cuh's idiom: N, N0 = -p^-1 mod 2^32,
// p(i) and one(i) (R mod p) as switches that fold to immediates inside
// unrolled loops, and LAZY: 4p < 2^(32 N), so values may stay in [0, 2p)
// between operations (csrc/ntt_block_n.cuh); false only for bls12-381 Fr.
// The field selector of the C entries is the struct's index below
// (curves/device.py KERNEL_FIELDS).
//
// nmul is force-inlined: K12 and K14 call it once a thread. The point
// formulas of K13 call it through nmul_call, __noinline__: a 12-word product
// is 2.25 times the 8-word one and a 24-word product 9 times, and a mixed
// add holds 11 to 39 of them, so inlined copies would multiply ptxas's time.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

// field 0: bls12-377 Fr, 253 bits, 8 words
struct Bls377Fr {
  static constexpr int N = 8;
  static constexpr u32 N0 = 0xffffffffu;  // -p^-1 mod 2^32
  static constexpr bool LAZY = true;  // 4p < 2^256
  __device__ static __forceinline__ u32 p(int i) {
    switch (i) {
      case 0: return 0x00000001u; case 1: return 0x0a118000u; case 2: return 0xd0000001u;
      case 3: return 0x59aa76feu; case 4: return 0x5c37b001u; case 5: return 0x60b44d1eu;
      case 6: return 0x9a2ca556u; default: return 0x12ab655eu;
    }
  }
  // R mod p: the Montgomery form of 1
  __device__ static __forceinline__ u32 one(int i) {
    switch (i) {
      case 0: return 0xfffffff3u; case 1: return 0x7d1c7fffu; case 2: return 0x6ffffff2u;
      case 3: return 0x7257f50fu; case 4: return 0x512c0feeu; case 5: return 0x16d81575u;
      case 6: return 0x2bbb9a9du; default: return 0x0d4bda32u;
    }
  }
};

// field 1: bls12-377 Fq = bw6-761 Fr, 377 bits, 12 words
struct Bls377Fq {
  static constexpr int N = 12;
  static constexpr u32 N0 = 0xffffffffu;  // -p^-1 mod 2^32
  static constexpr bool LAZY = true;  // 4p < 2^384
  __device__ static __forceinline__ u32 p(int i) {
    switch (i) {
      case 0: return 0x00000001u; case 1: return 0x8508c000u; case 2: return 0x30000000u;
      case 3: return 0x170b5d44u; case 4: return 0xba094800u; case 5: return 0x1ef3622fu;
      case 6: return 0x00f5138fu; case 7: return 0x1a22d9f3u; case 8: return 0x6ca1493bu;
      case 9: return 0xc63b05c0u; case 10: return 0x17c510eau; default: return 0x01ae3a46u;
    }
  }
  // R mod p: the Montgomery form of 1
  __device__ static __forceinline__ u32 one(int i) {
    switch (i) {
      case 0: return 0xffffff68u; case 1: return 0x02cdffffu; case 2: return 0x7fffffb1u;
      case 3: return 0x51409f83u; case 4: return 0x8a7d3ff2u; case 5: return 0x9f7db3a9u;
      case 6: return 0x6e7c6305u; case 7: return 0x7b4e97b7u; case 8: return 0x803c84e8u;
      case 9: return 0x4cf495bfu; case 10: return 0xe2fdf49au; default: return 0x008d6661u;
    }
  }
};

// field 2: bls12-381 Fr, 255 bits, 8 words
struct Bls381Fr {
  static constexpr int N = 8;
  static constexpr u32 N0 = 0xffffffffu;  // -p^-1 mod 2^32
  static constexpr bool LAZY = false;  // 4p > 2^256: r is 2^254.86
  __device__ static __forceinline__ u32 p(int i) {
    switch (i) {
      case 0: return 0x00000001u; case 1: return 0xffffffffu; case 2: return 0xfffe5bfeu;
      case 3: return 0x53bda402u; case 4: return 0x09a1d805u; case 5: return 0x3339d808u;
      case 6: return 0x299d7d48u; default: return 0x73eda753u;
    }
  }
  // R mod p: the Montgomery form of 1
  __device__ static __forceinline__ u32 one(int i) {
    switch (i) {
      case 0: return 0xfffffffeu; case 1: return 0x00000001u; case 2: return 0x00034802u;
      case 3: return 0x5884b7fau; case 4: return 0xecbc4ff5u; case 5: return 0x998c4fefu;
      case 6: return 0xacc5056fu; default: return 0x1824b159u;
    }
  }
};

// field 3: bls12-381 Fq, 381 bits, 12 words
struct Bls381Fq {
  static constexpr int N = 12;
  static constexpr u32 N0 = 0xfffcfffdu;  // -p^-1 mod 2^32
  static constexpr bool LAZY = true;  // 4p < 2^384
  __device__ static __forceinline__ u32 p(int i) {
    switch (i) {
      case 0: return 0xffffaaabu; case 1: return 0xb9feffffu; case 2: return 0xb153ffffu;
      case 3: return 0x1eabfffeu; case 4: return 0xf6b0f624u; case 5: return 0x6730d2a0u;
      case 6: return 0xf38512bfu; case 7: return 0x64774b84u; case 8: return 0x434bacd7u;
      case 9: return 0x4b1ba7b6u; case 10: return 0x397fe69au; default: return 0x1a0111eau;
    }
  }
  // R mod p: the Montgomery form of 1
  __device__ static __forceinline__ u32 one(int i) {
    switch (i) {
      case 0: return 0x0002fffdu; case 1: return 0x76090000u; case 2: return 0xc40c0002u;
      case 3: return 0xebf4000bu; case 4: return 0x53c758bau; case 5: return 0x5f489857u;
      case 6: return 0x70525745u; case 7: return 0x77ce5853u; case 8: return 0xa256ec6du;
      case 9: return 0x5c071a97u; case 10: return 0xfa80e493u; default: return 0x15f65ec3u;
    }
  }
};

// field 4: bw6-761 Fq, 761 bits, 24 words
struct Bw6Fq {
  static constexpr int N = 24;
  static constexpr u32 N0 = 0x8fa798ddu;  // -p^-1 mod 2^32
  static constexpr bool LAZY = true;  // 4p < 2^768
  __device__ static __forceinline__ u32 p(int i) {
    switch (i) {
      case 0: return 0x0000008bu; case 1: return 0xf49d0000u; case 2: return 0x70000082u;
      case 3: return 0xe6913e68u; case 4: return 0xeaf0a437u; case 5: return 0x160cf8aeu;
      case 6: return 0x5667a8f8u; case 7: return 0x98a116c2u; case 8: return 0x73ebff2eu;
      case 9: return 0x71dcd3dcu; case 10: return 0x12f9fd90u; case 11: return 0x8689c8edu;
      case 12: return 0x25b42304u; case 13: return 0x03cebaffu; case 14: return 0xe584e919u;
      case 15: return 0x707ba638u; case 16: return 0x8087be41u; case 17: return 0x528275efu;
      case 18: return 0x81d14688u; case 19: return 0xb926186au; case 20: return 0x04faff3eu;
      case 21: return 0xd187c940u; case 22: return 0xfb83ce0au; default: return 0x0122e824u;
    }
  }
  // R mod p: the Montgomery form of 1
  __device__ static __forceinline__ u32 one(int i) {
    switch (i) {
      case 0: return 0xffff85d5u; case 1: return 0x0202ffffu; case 2: return 0x8fff8ce7u;
      case 3: return 0x5a582635u; case 4: return 0x827faadeu; case 5: return 0x9e996e43u;
      case 6: return 0x0ee47df4u; case 7: return 0xda6aff32u; case 8: return 0x1d94b80bu;
      case 9: return 0xece9cb3eu; case 10: return 0x5248240bu; case 11: return 0xc0e667a2u;
      case 12: return 0xdcad3905u; case 13: return 0xa74da5bfu; case 14: return 0x462f2103u;
      case 15: return 0x2352e7feu; case 16: return 0x08b1c87cu; case 17: return 0x7b565880u;
      case 18: return 0xe711022fu; case 19: return 0x45848a63u; case 20: return 0x9f65a9dfu;
      case 21: return 0xd7a81ebbu; case 22: return 0xf127e87du; default: return 0x0051f77eu;
    }
  }
};

// r = t - p if t >= p else t (t < 2p, top the word carried past 2^(32 N))
template <class F>
__device__ __forceinline__ void ncond_sub_p(u32* r, const u32* t, u32 top) {
  u32 d[F::N];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    u64 s = (u64)t[j] - F::p(j) - borrow;
    d[j] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  bool ge = (top != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < F::N; j++) r[j] = ge ? d[j] : t[j];
}

// The CIOS rounds of a Montgomery product (field.cuh's fmul at N words), t of
// N + 2 words: t[0..N-1] with the carry word t[N] is (a b + M p) / 2^(32 N),
// below a b / 2^(32 N) + p.
template <class F>
__device__ __forceinline__ void nmont_rounds(u32* t, const u32* a, const u32* b) {
  constexpr int N = F::N;
#pragma unroll
  for (int j = 0; j < N + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      u64 s = (u64)a[j] * b[i] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[N] + c;
    t[N] = (u32)s;
    t[N + 1] = (u32)(s >> 32);
    u32 m = t[0] * F::N0;
    s = (u64)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (u64)m * F::p(j) + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[N] + c;
    t[N - 1] = (u32)s;
    t[N] = t[N + 1] + (u32)(s >> 32);
  }
}

// r = a * b * 2^-(32 N) mod p, canonical (a, b < p)
template <class F>
__device__ __forceinline__ void nmul(u32* r, const u32* a, const u32* b) {
  u32 t[F::N + 2];
  nmont_rounds<F>(t, a, b);
  ncond_sub_p<F>(r, t, t[F::N]);
}

template <class F>
__device__ __forceinline__ void nadd(u32* r, const u32* a, const u32* b) {
  u32 t[F::N];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    u64 s = (u64)a[j] + b[j] + c;
    t[j] = (u32)s;
    c = s >> 32;
  }
  ncond_sub_p<F>(r, t, (u32)c);
}

template <class F>
__device__ __forceinline__ void nsub(u32* r, const u32* a, const u32* b) {
  u32 t[F::N];
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    u64 s = (u64)a[j] - b[j] - borrow;
    t[j] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  // underflow: add p back
  u32 mask = borrow ? 0xffffffffu : 0u;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    u64 s = (u64)t[j] + (F::p(j) & mask) + c;
    r[j] = (u32)s;
    c = s >> 32;
  }
}

template <class F>
__device__ __forceinline__ bool n_is_zero(const u32* a) {
  u32 acc = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) acc |= a[j];
  return acc == 0;
}

template <class F>
__device__ __forceinline__ void nneg(u32* r, const u32* a) {
  u32 z[F::N];
#pragma unroll
  for (int j = 0; j < F::N; j++) z[j] = 0;
  if (n_is_zero<F>(a)) {
#pragma unroll
    for (int j = 0; j < F::N; j++) r[j] = 0;
  } else {
    nsub<F>(r, z, a);
  }
}

// Limb-major global layout: word k of lane i of an (N, n) block at k*n + i.
template <class F>
__device__ __forceinline__ void nload(u32* r, const u32* base, long long n, long long i) {
#pragma unroll
  for (int k = 0; k < F::N; k++) r[k] = base[k * n + i];
}

template <class F>
__device__ __forceinline__ void nstore(u32* base, long long n, long long i, const u32* a) {
#pragma unroll
  for (int k = 0; k < F::N; k++) base[k * n + i] = a[k];
}

// One field element by value, for the point formulas (curve_n.cuh).
template <class F>
struct Fe {
  u32 v[F::N];
};

template <class F>
__device__ __noinline__ Fe<F> nmul_call(const Fe<F> a, const Fe<F> b) {
  Fe<F> r;
  nmul<F>(r.v, a.v, b.v);
  return r;
}
