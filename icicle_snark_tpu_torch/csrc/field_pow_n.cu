// K16: a^e per element over the fields of the other curves (field_n.cuh:
// bls12-377 and bls12-381 Fr and Fq, bw6-761 Fq), Montgomery form in and out.
//
// Replaces icicle_snark_tpu/fields/limbs.py mont_pow_const (:516), mont_inv
// (:541, Fermat: a^(p-2), so 0 maps to 0) and batch_inv (:546) at the
// FieldSpec widths of icicle_snark_tpu/curves/device.py, as
// icicle_snark_tpu/ops/vec_ops.py inv (:42) and div (:46) use them. On the
// TPU the power is a lax.scan over the exponent's bits with two full-width
// multiplier graphs a step. K9 (field_pow.cu) keeps BN254.
//
// K9's design at F::N words: one thread owns one lane and runs the whole
// square-and-multiply out of registers. The exponent is the same for every
// lane and is passed by value (up to 24 words: p - 2 of bw6-761 Fq has 761
// bits); it is scanned from its top set bit down, so the branch is uniform
// across a warp. Each step is one Montgomery product, acc * acc or acc * a
// chosen word by word, so the loop holds a single force-inlined nmul: at 24
// words one product is some 2 400 multiply-adds of code.
//
// Bound: operations. (bit length + set bits - 1) products a lane of N (4N + 1)
// 32-bit multiplies each, against 8N bytes read and written: an inverse at
// 24 words is about 1 140 products, 2.8 million multiplies a lane for 192
// bytes. Every product ends canonical, so the result equals the plain
// version's (fields/limbs.py field_pow_plain) word for word.
#include "field_n.cuh"

#define POW_N_MAX_WORDS 24

struct ExponentN {
  u32 w[POW_N_MAX_WORDS];
};

template <class F>
__global__ void field_pow_n_kernel(u32* __restrict__ out, const u32* __restrict__ a,
                                   ExponentN e, int nbits, long long nb, long long n) {
  constexpr int N = F::N;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * n) return;
  long long bb = t / n, i = t - bb * n;
  u32 x[N], acc[N], y[N];
  nload<F>(x, a + bb * N * n, n, i);
#pragma unroll
  for (int k = 0; k < N; k++) acc[k] = F::one(k);
  // bit by bit from the top: square, then multiply by a where the bit is set
  int bit = nbits - 1;
  bool square = true;
#pragma unroll 1
  while (bit >= 0) {
#pragma unroll
    for (int k = 0; k < N; k++) y[k] = square ? acc[k] : x[k];
    nmul<F>(acc, acc, y);
    if (square && ((e.w[bit >> 5] >> (bit & 31)) & 1)) {
      square = false;
    } else {
      square = true;
      bit--;
    }
  }
  nstore<F>(out + bb * N * n, n, i, acc);
}

template <class F>
static void launch(void* out, const void* a, const ExponentN& e, int nbits, long long nb,
                   long long n, cudaStream_t s) {
  int threads = 128;
  long long blocks = (nb * n + threads - 1) / threads;
  field_pow_n_kernel<F><<<blocks, threads, 0, s>>>((u32*)out, (const u32*)a, e, nbits, nb, n);
}

// field: curves/device.py KERNEL_FIELDS; out, a: (nb, N, n); exponent: its
// (nbits + 31) / 32 little-endian words on the host, nbits <= 768 (0 gives
// the Montgomery one in every lane)
extern "C" int snark_field_pow_n(int field, void* out, const void* a, const void* exponent,
                                 int nbits, long long nb, long long n, void* stream) {
  if (nbits < 0 || nbits > 32 * POW_N_MAX_WORDS) return (int)cudaErrorInvalidValue;
  if (nb * n == 0) return 0;
  ExponentN e;
  const u32* w = (const u32*)exponent;
  for (int k = 0; k < POW_N_MAX_WORDS; k++) e.w[k] = k < (nbits + 31) / 32 ? w[k] : 0u;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: launch<Bls377Fr>(out, a, e, nbits, nb, n, s); break;
    case 1: launch<Bls377Fq>(out, a, e, nbits, nb, n, s); break;
    case 2: launch<Bls381Fr>(out, a, e, nbits, nb, n, s); break;
    case 3: launch<Bls381Fq>(out, a, e, nbits, nb, n, s); break;
    case 4: launch<Bw6Fq>(out, a, e, nbits, nb, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
