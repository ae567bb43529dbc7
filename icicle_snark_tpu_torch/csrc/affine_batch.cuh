// K7 point_to_affine (precompute.cu): projective -> affine by a batched
// inverse, L lanes a thread.
//
// Replaces icicle_snark_tpu/ops/msm.py to_affine_device (:414) and
// icicle_snark_tpu/setup/fast_setup.py _to_affine_bytes (:98), which invert
// z with fields/limbs.py batch_inv (:546), the Montgomery trick, z = 0
// replaced by one and masked. This kernel computes it the same way.
//
// The kernel before this one inverted each lane's z by Fermat (254 squarings
// and 110 products, about 370 Fq products a lane), so 2.0x its bound was
// still that whole exponentiation per lane. Here thread t of T = ceil(n / L)
// takes lanes t, t + T, ..., t + (L - 1) T (a warp's loads stay coalesced):
//   forward:  v_k = z_k (G1) or the norm a^2 + b^2 of z_k = a + bu (G2); a
//             lane with z = 0 (or past n) contributes one and keeps a flag;
//             pre_k = v_0 ... v_k;
//   one Fermat inversion of pre_{L-1} (fq_inv, out of line);
//   backward: v_k^-1 = inv pre_{k-1}, then inv = inv v_k; z^-1 = v^-1 (G1)
//             or (a - bu) v^-1 (G2); x z^-1, y z^-1 (Karatsuba on G2), and
//             (0, 0) for a flagged lane.
// v and pre live in local memory (L x 64 bytes a thread). Work per lane: G1
// 5 Fq products + 370 / L against 160 bytes, G2 13 + 370 / L against 320.
// Every product is field.cuh's canonical one, and affine coordinates are
// unique, so the output equals jcurve.to_affine_plain word for word.
#pragma once
#include "curve.cuh"

// q - 2, little-endian words
__constant__ u32 Q_MINUS_2[8] = {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                                 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};

// a^(q-2): the Montgomery form of a^-1 (0 for a = 0)
__device__ __noinline__ E1 fq_inv(const E1& a) {
  E1 acc;
  e_set_one(acc);
#pragma unroll 1
  for (int bit = 253; bit >= 0; bit--) {
    acc = e_mul(acc, acc);
    if ((Q_MINUS_2[bit >> 5] >> (bit & 31)) & 1) acc = e_mul(acc, a);
  }
  return acc;
}

// the Fq value a lane inverts: z itself, or z's norm (z = 0 iff its norm is
// 0, as -1 is not a square mod q)
__device__ __forceinline__ E1 inv_value(const E1& z) { return z; }
__device__ __forceinline__ E1 inv_value(const E2& z) {
  return e_add(e_mul(z.c0, z.c0), e_mul(z.c1, z.c1));
}

// z^-1 from v^-1
__device__ __forceinline__ E1 z_inverse(const E1&, const E1& vinv) { return vinv; }
__device__ __forceinline__ E2 z_inverse(const E2& z, const E1& vinv) {
  return {e_mul(z.c0, vinv), e_mul(e_neg(z.c1), vinv)};
}

// thread t of T: lanes t + k T, k < L, of in (3, C, 8, n) into ox, oy (C, 8, n)
template <class E, int L>
__device__ __forceinline__ void affine_batch_thread(u32* __restrict__ ox, u32* __restrict__ oy,
                                                    const u32* __restrict__ in, long long n,
                                                    long long t, long long T) {
  static_assert(L >= 1 && L <= 32, "one flag bit a lane");
  constexpr int W = ECoord<E>::WORDS;
  const u32* zin = in + 2LL * W * n;
  E1 v[L], pre[L];
  u32 flagged = 0;
  E1 acc;
#pragma unroll 1
  for (int k = 0; k < L; k++) {
    long long i = t + k * T;
    E1 vk;
    bool none = true;
    if (i < n) {
      E z;
      e_load(z, zin, n, i);
      vk = inv_value(z);
      none = e_is_zero(vk);
    }
    if (none) {
      flagged |= 1u << k;
      e_set_one(vk);
    }
    v[k] = vk;
    acc = k ? e_mul(acc, vk) : vk;
    pre[k] = acc;
  }
  E1 inv = fq_inv(acc);
#pragma unroll 1
  for (int k = L - 1; k >= 0; k--) {
    E1 vinv = inv;
    if (k) {
      vinv = e_mul(inv, pre[k - 1]);
      inv = e_mul(inv, v[k]);
    }
    long long i = t + k * T;
    if (i >= n) continue;
    E ax, ay;
    if ((flagged >> k) & 1) {
      e_set_zero(ax);
      e_set_zero(ay);
    } else {
      E z, x, y;
      e_load(z, zin, n, i);
      e_load(x, in, n, i);
      e_load(y, in + (long long)W * n, n, i);
      E zi = z_inverse(z, vinv);
      ax = e_mul(x, zi);
      ay = e_mul(y, zi);
    }
    e_store(ox, n, i, ax);
    e_store(oy, n, i, ay);
  }
}
