// K7: the two per-lane chains of MSM base precompute.
//
// Replaces icicle_snark_tpu/ops/msm.py precompute_bases (:431) with
// to_affine_device (:414), and fields/limbs.py mont_pow_const / mont_inv /
// batch_inv (:516/:541/:546) as they are used there and in
// setup/fast_setup.py _to_affine_bytes: the shifted base copies
// 2^(c * wp * m) * P of the proving key, stored affine.
//
//   point_dbl_k:     k complete doublings of each projective point (RCB15
//                    algorithm 9 in a loop). z = 0 stays z = 0. G1: one
//                    thread a lane (curve.cuh p_dbl). G2: a lane on a pair
//                    of threads, each holding one Fq component of x, y and z
//                    (curve_pair.cuh pair_dbl, inlined: one call site), so
//                    the 48-word point stays in registers across the loop.
//   point_to_affine: z^-1 per lane by Fermat, square-and-multiply over the
//                    bits of q - 2 held in __constant__ memory, then x z^-1,
//                    y z^-1. z = 0 gives 0^(q-2) = 0 and so (0, 0), the
//                    affine encoding of infinity, with no branch. G2 inverts
//                    through the norm: (a + bu)^-1 = (a - bu) / (a^2 + b^2).
// The TPU version inverted a whole batch with the Montgomery trick because a
// per-lane exponentiation was 380 full-width graph steps; a Hopper thread
// runs the 254 squarings and 110 products (the set bits of q - 2) out of
// registers, and lanes stay independent.
//
// Projective results of the same formulas and affine coordinates are unique
// canonical words, so both entries equal their plain versions (jcurve.pdbl
// looped, jcurve.to_affine_plain) word for word.
//
// Bound: operations. G2 at complex-100k with (c, f) = (13, 4): shift = 65
// doublings x 27 Fq products (the Karatsuba count; the pair does 32, two
// squares at one product a thread) + one inversion (about 370 products) per
// lane and copy, against 384 bytes per lane. Registers and spills of each
// kernel are printed by -Xptxas -v at build.
#include "curve_pair.cuh"

// q - 2, little-endian words
__constant__ u32 Q_MINUS_2[8] = {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                                 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};

__global__ void point_dbl_k_kernel(u32* __restrict__ out, const u32* __restrict__ in,
                                   long long n, int k) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<E1> p = p_load<E1>(in, n, i);
#pragma unroll 1
  for (int s = 0; s < k; s++) p = p_dbl(p);
  p_store(out, n, i, p);
}

// G2: threads 2i and 2i + 1 hold lane i's c0 and c1 components
__global__ void point_dbl_k_pair_kernel(u32* __restrict__ out, const u32* __restrict__ in,
                                        long long n, int k) {
  long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  if (i >= n) return;  // both threads of a pair
  PairLane pl = pair_lane();
  Pt<E1> p = pair_load(in, n, i, pl);
#pragma unroll 1
  for (int s = 0; s < k; s++) p = pair_dbl(p, pl);
  pair_store(out, n, i, pl, p);
}

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

__device__ __forceinline__ E1 e_inv(const E1& a) { return fq_inv(a); }

__device__ __forceinline__ E2 e_inv(const E2& a) {
  E1 norm = e_add(e_mul(a.c0, a.c0), e_mul(a.c1, a.c1));
  E1 ninv = fq_inv(norm);
  return {e_mul(a.c0, ninv), e_mul(e_neg(a.c1), ninv)};
}

template <class E>
__global__ void point_to_affine_kernel(u32* __restrict__ ox, u32* __restrict__ oy,
                                       const u32* __restrict__ in, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<E> p = p_load<E>(in, n, i);
  E zi = e_inv(p.z);
  e_store(ox, n, i, e_mul(p.x, zi));
  e_store(oy, n, i, e_mul(p.y, zi));
}

// out, in: (3, C, 8, n)
extern "C" int snark_point_dbl_k(int g2, void* out, const void* in, long long n, int k,
                                 void* stream) {
  if (n == 0) return 0;
  int threads = 128;
  long long nthreads = g2 ? 2 * n : n;  // G2: a pair of threads a lane
  long long blocks = (nthreads + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    point_dbl_k_pair_kernel<<<blocks, threads, 0, s>>>((u32*)out, (const u32*)in, n, k);
  else
    point_dbl_k_kernel<<<blocks, threads, 0, s>>>((u32*)out, (const u32*)in, n, k);
  return (int)cudaGetLastError();
}

// ox, oy: (C, 8, n); in: (3, C, 8, n)
extern "C" int snark_point_to_affine(int g2, void* ox, void* oy, const void* in, long long n,
                                     void* stream) {
  if (n == 0) return 0;
  int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    point_to_affine_kernel<E2><<<blocks, threads, 0, s>>>((u32*)ox, (u32*)oy, (const u32*)in, n);
  else
    point_to_affine_kernel<E1><<<blocks, threads, 0, s>>>((u32*)ox, (u32*)oy, (const u32*)in, n);
  return (int)cudaGetLastError();
}
