// K10: modular sum or Montgomery product over the last axis, any number of rows.
//
// Replaces icicle_snark_tpu/ops/vec_ops.py sum_reduce (:68) and product_reduce
// (:80): on the TPU a log-depth tree of full-width add_mod / mont_mul graphs,
// one level per halving, the odd tail padded with 0 (sum) or the Montgomery
// one (product).
//
// Here a launch cuts each row of n elements into `blocks` spans; a block of
// 256 threads folds its span, each thread a strided run of elements into a
// register accumulator (coalesced limb-major loads), then the threads' values
// in a tree through shared memory, and writes one partial per (row, block).
// The wrapper (ops/vec_ops.py field_reduce) launches once more over the
// partials with one block a row when there is more than one. Addition mod p
// and the Montgomery product of Montgomery-form values (x R * y R / R = x y R)
// are associative and commutative, and every step ends canonical, so any tree
// gives the plain version's (the JAX pairing's) words. Empty accumulators hold
// 0 or the Montgomery one, the identities the JAX code pads with.
//
// Bound: the sum by bytes (32 bytes read per element), the product by
// operations (264 32-bit multiplies per element).
#include "field.cuh"

#define REDUCE_THREADS 256

template <class F, bool PROD>
__device__ __forceinline__ void combine(u32 acc[8], const u32 v[8]) {
  if (PROD)
    fmul<F>(acc, acc, v);
  else
    fadd<F>(acc, acc, v);
}

template <class F, bool PROD>
__global__ void __launch_bounds__(REDUCE_THREADS)
field_reduce_kernel(u32* __restrict__ out, const u32* __restrict__ in, long long n,
                    long long blocks) {
  __shared__ u32 sh[8][REDUCE_THREADS];
  long long row = blockIdx.x / blocks, b = blockIdx.x - row * blocks;
  long long chunk = (n + blocks - 1) / blocks;
  long long lo = b * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const u32* base = in + row * 8 * n;
  int tid = threadIdx.x;
  u32 acc[8], v[8];
#pragma unroll
  for (int k = 0; k < 8; k++) acc[k] = PROD ? F::one(k) : 0u;
#pragma unroll 1
  for (long long i = lo + tid; i < hi; i += REDUCE_THREADS) {
    fload(v, base, n, i);
    combine<F, PROD>(acc, v);
  }
#pragma unroll
  for (int k = 0; k < 8; k++) sh[k][tid] = acc[k];
  __syncthreads();
#pragma unroll 1
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < 8; k++) v[k] = sh[k][tid + s];
      combine<F, PROD>(acc, v);
#pragma unroll
      for (int k = 0; k < 8; k++) sh[k][tid] = acc[k];
    }
    __syncthreads();
  }
  if (tid == 0) fstore(out + row * 8 * blocks, blocks, b, acc);
}

// op 0 sum, 1 product; in: (rows, 8, n); out: (rows, 8, blocks)
extern "C" int snark_field_reduce(int op, int field, void* out, const void* in, long long rows,
                                  long long n, long long blocks, void* stream) {
  if (rows == 0) return 0;
  long long grid = rows * blocks;
  cudaStream_t s = (cudaStream_t)stream;
  u32* o = (u32*)out;
  const u32* x = (const u32*)in;
  if (field == 0) {
    if (op)
      field_reduce_kernel<Fr, true><<<grid, REDUCE_THREADS, 0, s>>>(o, x, n, blocks);
    else
      field_reduce_kernel<Fr, false><<<grid, REDUCE_THREADS, 0, s>>>(o, x, n, blocks);
  } else {
    if (op)
      field_reduce_kernel<Fq, true><<<grid, REDUCE_THREADS, 0, s>>>(o, x, n, blocks);
    else
      field_reduce_kernel<Fq, false><<<grid, REDUCE_THREADS, 0, s>>>(o, x, n, blocks);
  }
  return (int)cudaGetLastError();
}
