// K10: modular sum or Montgomery product over the last axis, any number of rows.
//
// Replaces icicle_snark_tpu/ops/vec_ops.py sum_reduce (:68) and product_reduce
// (:80): on the TPU a log-depth tree of full-width add_mod / mont_mul graphs,
// one level per halving, the odd tail padded with 0 (sum) or the Montgomery
// one (product).
//
// The sum: a launch cuts each row of n elements into `blocks` spans; a block
// of 256 threads folds its span, each thread a strided run of elements into a
// register accumulator (coalesced limb-major loads), then the threads' values
// in a tree through shared memory, and writes one partial per (row, block).
// The product: field_product.cuh's fold into PRODUCT_ACC accumulators a
// thread and warp-shuffle tree, on field.cuh's fmul. The wrapper (ops/vec_ops.py
// field_reduce) sizes each grid and launches once more over the partials
// with one block a row when there is more than one. Addition mod p and the
// Montgomery product of Montgomery-form values (x R * y R / R = x y R) are
// associative and commutative, and every step ends canonical, so any tree
// gives the plain version's (the JAX pairing's) words. Empty accumulators
// hold 0 or the Montgomery one, the identities the JAX code pads with.
//
// Bound: the sum by bytes (32 bytes read per element), the product by
// operations (264 32-bit multiplies per element).
#include "field.cuh"
#include "field_product.cuh"

#define REDUCE_THREADS 256

template <class F>
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
  for (int k = 0; k < 8; k++) acc[k] = 0u;
#pragma unroll 1
  for (long long i = lo + tid; i < hi; i += REDUCE_THREADS) {
    fload(v, base, n, i);
    fadd<F>(acc, acc, v);
  }
#pragma unroll
  for (int k = 0; k < 8; k++) sh[k][tid] = acc[k];
  __syncthreads();
#pragma unroll 1
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < 8; k++) v[k] = sh[k][tid + s];
      fadd<F>(acc, acc, v);
#pragma unroll
      for (int k = 0; k < 8; k++) sh[k][tid] = acc[k];
    }
    __syncthreads();
  }
  if (tid == 0) fstore(out + row * 8 * blocks, blocks, b, acc);
}

// field.cuh's product as field_product.cuh's M
template <class F>
struct FieldMul {
  static constexpr int N = 8;
  __device__ static __forceinline__ void mul(u32* r, const u32* a, const u32* b) {
    fmul<F>(r, a, b);
  }
  __device__ static __forceinline__ u32 one(int k) { return F::one(k); }
};

template <class F>
__global__ void __launch_bounds__(PRODUCT_THREADS)
field_product_kernel(u32* __restrict__ out, const u32* __restrict__ in, long long n,
                     long long blocks) {
  extern __shared__ u32 product_sm[];
  product_reduce_body<FieldMul<F>, PRODUCT_ACC>(out, in, n, blocks, blockIdx.x, threadIdx.x,
                                                blockDim.x, product_sm);
}

template <class F>
static int launch_product(u32* out, const u32* in, long long grid, long long n, long long blocks,
                          cudaStream_t s) {
  constexpr int smem = product_smem_bytes(8, PRODUCT_ACC);
  static_assert(smem <= 48 * 1024, "the product's shared memory needs no opt-in");
  field_product_kernel<F><<<grid, PRODUCT_THREADS, smem, s>>>(out, in, n, blocks);
  return (int)cudaGetLastError();
}

template <class F>
static int launch(int op, u32* out, const u32* in, long long grid, long long n, long long blocks,
                  cudaStream_t s) {
  if (op) return launch_product<F>(out, in, grid, n, blocks, s);
  field_reduce_kernel<F><<<grid, REDUCE_THREADS, 0, s>>>(out, in, n, blocks);
  return (int)cudaGetLastError();
}

// op 0 sum, 1 product; field 0 Fr, 1 Fq; in: (rows, 8, n); out: (rows, 8, blocks)
extern "C" int snark_field_reduce(int op, int field, void* out, const void* in, long long rows,
                                  long long n, long long blocks, void* stream) {
  if (rows == 0) return 0;
  long long grid = rows * blocks;
  cudaStream_t s = (cudaStream_t)stream;
  u32* o = (u32*)out;
  const u32* x = (const u32*)in;
  return field == 0 ? launch<Fr>(op, o, x, grid, n, blocks, s)
                    : launch<Fq>(op, o, x, grid, n, blocks, s);
}
