// K9: a^e per element for Fr and Fq (Montgomery form in and out).
//
// Replaces icicle_snark_tpu/fields/limbs.py mont_pow_const (:516), mont_inv
// (:541, Fermat: a^(p-2), so 0 maps to 0) and batch_inv (:546) as the op
// surface uses them (ops/vec_ops.py inv and div). On the TPU the power is a
// lax.scan over the exponent's bits with two full-width multiplier graphs per
// step; the port composed it of one K1 launch per square and per product.
//
// Here one thread owns one lane and runs the whole square-and-multiply out of
// registers: the exponent (8 words, passed by value, the same for every lane)
// is scanned from its top set bit down, so the branch is uniform across a
// warp. An inverse (254 bits of p - 2; 127 of them set for Fr, 110 for Fq) is
// 381 (Fr) or 364 (Fq) Montgomery products per lane against 64 bytes read and
// written: bound by operations, by a factor of some 300 over the bytes. The
// product is field.cuh's fmul, whose 32 x 32 -> 64-bit multiply-adds compile
// to IMAD.WIDE.U32 (PERF.md, the SASS census), canonical after every step, so
// the result equals the plain version's (fields/limbs.py field_pow_plain)
// word for word.
#include "field.cuh"

struct Exponent {
  u32 w[8];
};

template <class F>
__global__ void field_pow_kernel(u32* __restrict__ out, const u32* __restrict__ a, Exponent e,
                                 int nbits, long long nb, long long n) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * n) return;
  long long bb = t / n, i = t - bb * n;
  u32 x[8], acc[8];
  fload(x, a + bb * 8 * n, n, i);
#pragma unroll
  for (int k = 0; k < 8; k++) acc[k] = F::one(k);
#pragma unroll 1
  for (int bit = nbits - 1; bit >= 0; bit--) {
    fmul<F>(acc, acc, acc);
    if ((e.w[bit >> 5] >> (bit & 31)) & 1) fmul<F>(acc, acc, x);
  }
  fstore(out + bb * 8 * n, n, i, acc);
}

// out, a: (nb, 8, n); exponent: 8 little-endian words on the host, nbits its
// bit length (0 gives the Montgomery one in every lane)
extern "C" int snark_field_pow(int field, void* out, const void* a, const void* exponent,
                               int nbits, long long nb, long long n, void* stream) {
  long long lanes = nb * n;
  if (lanes == 0) return 0;
  Exponent e;
  const u32* w = (const u32*)exponent;
  for (int k = 0; k < 8; k++) e.w[k] = w[k];
  int threads = 256;
  long long blocks = (lanes + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    field_pow_kernel<Fr><<<blocks, threads, 0, s>>>((u32*)out, (const u32*)a, e, nbits, nb, n);
  else
    field_pow_kernel<Fq><<<blocks, threads, 0, s>>>((u32*)out, (const u32*)a, e, nbits, nb, n);
  return (int)cudaGetLastError();
}
