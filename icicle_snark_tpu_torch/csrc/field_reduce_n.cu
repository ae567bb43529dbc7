// K17: modular sum or Montgomery product over the last axis, any number of
// rows, over the fields of the other curves (field_n.cuh).
//
// Replaces icicle_snark_tpu/ops/vec_ops.py sum_reduce (:68) and product_reduce
// (:80) at the FieldSpec widths of icicle_snark_tpu/curves/device.py: on the
// TPU a log-depth tree of full-width add_mod / mont_mul graphs, one level per
// halving, the odd tail padded with 0 (sum) or the Montgomery one (product).
// K10 (field_reduce.cu) keeps BN254.
//
// The sum: K10's two-launch block tree at F::N words: a launch cuts each row
// of n elements into `blocks` spans; a block of 256 threads folds its span,
// each thread a strided run of elements into a register accumulator
// (coalesced limb-major loads), then the threads' values in a tree through
// shared memory (sh[N][256]: 24 KB at 24 words), and writes one partial per
// (row, block). The product: field_product.cuh's fold into PRODUCT_ACC
// accumulators a thread and warp-shuffle tree, on nmul, as K10's product.
// The wrapper (ops/vec_ops.py field_reduce) sizes each grid and launches once
// more over the partials with one block a row when there is more than one.
// Addition mod p and the Montgomery product are associative and commutative
// and every step ends canonical, so any tree gives the plain version's (the
// JAX pairing's) words. Empty accumulators hold 0 or the Montgomery one.
//
// The product is built for the two 8-word Fr only: the JAX product_reduce
// reshapes its one to (NLIMB, 1) and fails at 12 and 24 words, and the port's
// wrapper refuses those fields as it does.
//
// Bound: the sum by bytes (4N bytes read per element), the product by
// operations (N (4N + 1) 32-bit multiplies per element).
#include "field_n.cuh"
#include "field_product.cuh"

#define REDUCE_N_THREADS 256

template <class F>
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
  for (int k = 0; k < N; k++) acc[k] = 0u;
#pragma unroll 1
  for (long long i = lo + tid; i < hi; i += REDUCE_N_THREADS) {
    nload<F>(v, base, n, i);
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
      nadd<F>(acc, acc, v);
#pragma unroll
      for (int k = 0; k < N; k++) sh[k][tid] = acc[k];
    }
    __syncthreads();
  }
  if (tid == 0) nstore<F>(out + row * N * blocks, blocks, b, acc);
}

// field_n.cuh's product as field_product.cuh's M
template <class F>
struct FieldMulN {
  static constexpr int N = F::N;
  __device__ static __forceinline__ void mul(u32* r, const u32* a, const u32* b) {
    nmul<F>(r, a, b);
  }
  __device__ static __forceinline__ u32 one(int k) { return F::one(k); }
};

template <class F>
__global__ void __launch_bounds__(PRODUCT_THREADS)
field_product_n_kernel(u32* __restrict__ out, const u32* __restrict__ in, long long n,
                       long long blocks) {
  extern __shared__ u32 product_sm[];
  product_reduce_body<FieldMulN<F>, PRODUCT_ACC>(out, in, n, blocks, blockIdx.x, threadIdx.x,
                                                 blockDim.x, product_sm);
}

template <class F>
static int launch_product(u32* out, const u32* in, long long grid, long long n, long long blocks,
                          cudaStream_t s) {
  constexpr int smem = product_smem_bytes(F::N, PRODUCT_ACC);
  static_assert(smem <= 48 * 1024, "the product's shared memory needs no opt-in");
  field_product_n_kernel<F><<<grid, PRODUCT_THREADS, smem, s>>>(out, in, n, blocks);
  return (int)cudaGetLastError();
}

template <class F>
static int launch_sum(void* out, const void* in, long long grid, long long n, long long blocks,
                      cudaStream_t s) {
  field_reduce_n_kernel<F><<<grid, REDUCE_N_THREADS, 0, s>>>((u32*)out, (const u32*)in, n, blocks);
  return (int)cudaGetLastError();
}

// op 0 sum, 1 product (fields 0 and 2 only); field: curves/device.py
// KERNEL_FIELDS; in: (rows, N, n); out: (rows, N, blocks)
extern "C" int snark_field_reduce_n(int op, int field, void* out, const void* in,
                                    long long rows, long long n, long long blocks, void* stream) {
  if (rows == 0) return 0;
  const long long grid = rows * blocks;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op * 8 + field) {
    case 0: return launch_sum<Bls377Fr>(out, in, grid, n, blocks, s);
    case 1: return launch_sum<Bls377Fq>(out, in, grid, n, blocks, s);
    case 2: return launch_sum<Bls381Fr>(out, in, grid, n, blocks, s);
    case 3: return launch_sum<Bls381Fq>(out, in, grid, n, blocks, s);
    case 4: return launch_sum<Bw6Fq>(out, in, grid, n, blocks, s);
    case 8: return launch_product<Bls377Fr>((u32*)out, (const u32*)in, grid, n, blocks, s);
    case 10: return launch_product<Bls381Fr>((u32*)out, (const u32*)in, grid, n, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
