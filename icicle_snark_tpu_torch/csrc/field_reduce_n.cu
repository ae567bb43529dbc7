// K17: modular sum or Montgomery product over the last axis, any number of
// rows, over the fields of the other curves (field_n.cuh).
//
// Replaces icicle_snark_tpu/ops/vec_ops.py sum_reduce (:68) and product_reduce
// (:80) at the FieldSpec widths of icicle_snark_tpu/curves/device.py: on the
// TPU a log-depth tree of full-width add_mod / mont_mul graphs, one level per
// halving, the odd tail padded with 0 (sum) or the Montgomery one (product).
// K10 (field_reduce.cu) keeps BN254.
//
// K10's two-launch block tree at F::N words: a launch cuts each row of n
// elements into `blocks` spans; a block of 256 threads folds its span, each
// thread a strided run of elements into a register accumulator (coalesced
// limb-major loads), then the threads' values in a tree through shared memory
// (sh[N][256]: 24 KB at 24 words), and writes one partial per (row, block).
// The wrapper (ops/vec_ops.py field_reduce) launches once more over the
// partials with one block a row when there is more than one. Addition mod p
// and the Montgomery product are associative and commutative and every step
// ends canonical, so any tree gives the plain version's (the JAX pairing's)
// words. Empty accumulators hold 0 or the Montgomery one.
//
// The product is built for the two 8-word Fr only: the JAX product_reduce
// reshapes its one to (NLIMB, 1) and fails at 12 and 24 words, and the port's
// wrapper refuses those fields as it does.
//
// Bound: the sum by bytes (4N bytes read per element), the product by
// operations (N (4N + 1) 32-bit multiplies per element).
#include "field_n.cuh"

#define REDUCE_N_THREADS 256

template <class F, bool PROD>
__global__ void __launch_bounds__(REDUCE_N_THREADS)
field_reduce_n_kernel(u32* __restrict__ out, const u32* __restrict__ in, long long n,
                      long long blocks) {
  constexpr int N = F::N;
  __shared__ u32 sh[N][REDUCE_N_THREADS];
  long long row = blockIdx.x / blocks, b = blockIdx.x - row * blocks;
  long long chunk = (n + blocks - 1) / blocks;
  long long lo = b * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const u32* base = in + row * N * n;
  int tid = threadIdx.x;
  u32 acc[N], v[N];
#pragma unroll
  for (int k = 0; k < N; k++) acc[k] = PROD ? F::one(k) : 0u;
#pragma unroll 1
  for (long long i = lo + tid; i < hi; i += REDUCE_N_THREADS) {
    nload<F>(v, base, n, i);
    if (PROD)
      nmul<F>(acc, acc, v);
    else
      nadd<F>(acc, acc, v);
  }
#pragma unroll
  for (int k = 0; k < N; k++) sh[k][tid] = acc[k];
  __syncthreads();
#pragma unroll 1
  for (int s = REDUCE_N_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < N; k++) v[k] = sh[k][tid + s];
      if (PROD)
        nmul<F>(acc, acc, v);
      else
        nadd<F>(acc, acc, v);
#pragma unroll
      for (int k = 0; k < N; k++) sh[k][tid] = acc[k];
    }
    __syncthreads();
  }
  if (tid == 0) nstore<F>(out + row * N * blocks, blocks, b, acc);
}

template <class F, bool PROD>
static void launch(void* out, const void* in, long long rows, long long n, long long blocks,
                   cudaStream_t s) {
  field_reduce_n_kernel<F, PROD><<<rows * blocks, REDUCE_N_THREADS, 0, s>>>(
      (u32*)out, (const u32*)in, n, blocks);
}

// op 0 sum, 1 product (fields 0 and 2 only); field: curves/device.py
// KERNEL_FIELDS; in: (rows, N, n); out: (rows, N, blocks)
extern "C" int snark_field_reduce_n(int op, int field, void* out, const void* in,
                                    long long rows, long long n, long long blocks,
                                    void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op * 8 + field) {
    case 0: launch<Bls377Fr, false>(out, in, rows, n, blocks, s); break;
    case 1: launch<Bls377Fq, false>(out, in, rows, n, blocks, s); break;
    case 2: launch<Bls381Fr, false>(out, in, rows, n, blocks, s); break;
    case 3: launch<Bls381Fq, false>(out, in, rows, n, blocks, s); break;
    case 4: launch<Bw6Fq, false>(out, in, rows, n, blocks, s); break;
    case 8: launch<Bls377Fr, true>(out, in, rows, n, blocks, s); break;
    case 10: launch<Bls381Fr, true>(out, in, rows, n, blocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
