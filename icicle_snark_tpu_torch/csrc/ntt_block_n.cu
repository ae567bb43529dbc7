// K14's passes (ntt_block_n.cuh, where the design is): the kernel, its
// launch and its C entry. One block a tile of a batch row; the tile and its
// twiddles in dynamic shared memory, 8N bytes an element.
#include "ntt_block_n.cuh"

// Two blocks an SM (a 2^10 tile: 128 / 192 KB of shared memory for the two)
// cap the registers at 128: a stage pair fits at 8 words (4-12 B spilled)
// and spills 68 B at 12. One stage an exchange at 12 words (106 registers,
// no spill) was no faster on an H100: 7.61 ms against 7.57-7.61 for the pair
// at 2^22 in the same call (PERF.md PR 11), so every width runs pairs.
#define NTTN_SMEM_MAX (227 * 1024)
#define NTTN_MIN_BLOCKS 2

template <class F, int MODE>
__global__ void __launch_bounds__(NTTN_THREADS, NTTN_MIN_BLOCKS)
    ntt_block_n_kernel(u32* __restrict__ x, const u32* __restrict__ tw,
                       const u32* __restrict__ mul, long long mul_lanes, int batch, long long n,
                       int low, int k, int tc, int inverse) {
  extern __shared__ u32 nb_sm[];
  ntt_block_n_body<F, MODE>(x, tw, mul, mul_lanes, batch, n, low, k, tc, inverse != 0, nb_sm,
                            blockIdx.x, threadIdx.x, blockDim.x);
}

template <class F, int MODE>
static int nb_launch(u32* x, const u32* tw, const u32* mul, long long mul_lanes, long long batch,
                     long long n, int low, int k, int tc, int inverse, cudaStream_t stream) {
  const int tile_log = k + tc;
  const size_t smem = (size_t)(8 * F::N) << tile_log;
  if (smem > NTTN_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ntt_block_n_kernel<F, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = nb_block_threads(tile_log);
  const long long blocks = batch * (n >> tile_log);
  ntt_block_n_kernel<F, MODE><<<blocks, threads, smem, stream>>>(x, tw, mul, mul_lanes, (int)batch,
                                                                 n, low, k, tc, inverse);
  return (int)cudaGetLastError();
}

template <class F>
static int nb_dispatch(void* x, const void* tw, const void* mul, long long mul_lanes,
                       long long batch, long long n, int low, int k, int tc, int inverse,
                       cudaStream_t s) {
  if (mul)
    return nb_launch<F, NTTN_SCALE>((u32*)x, (const u32*)tw, (const u32*)mul, mul_lanes, batch, n,
                                    low, k, tc, inverse, s);
  return nb_launch<F, NTTN_PLAIN>((u32*)x, (const u32*)tw, nullptr, 0, batch, n, low, k, tc,
                                  inverse, s);
}

// One pass: stages of spans 2^(low+1) .. 2^(low+k) of every row of x
// (batch, N, n) in place, tiles of 2^k rows x 2^tcols_log columns
// (tcols_log <= low), with the (N, n) stage-major table tw. mul NULL:
// PLAIN; mul (N, mul_lanes), mul_lanes 1 or n: SCALE (inverse, low = 0).
// field: the K12 selector (curves/device.py KERNEL_FIELDS), 0, 1 or 2.
extern "C" int snark_ntt_block_n(int field, void* x, const void* tw, const void* mul,
                                 long long mul_lanes, long long batch, long long n, int log_n,
                                 int low, int k, int tcols_log, int inverse, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (k < 1 || tcols_log < 0 || tcols_log > low || low + k > log_n || (1LL << log_n) != n)
    return (int)cudaErrorInvalidValue;
  if (mul && (!inverse || low != 0 || (mul_lanes != 1 && mul_lanes != n)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0:
      return nb_dispatch<Bls377Fr>(x, tw, mul, mul_lanes, batch, n, low, k, tcols_log, inverse, s);
    case 1:
      return nb_dispatch<Bls377Fq>(x, tw, mul, mul_lanes, batch, n, low, k, tcols_log, inverse, s);
    case 2:
      return nb_dispatch<Bls381Fr>(x, tw, mul, mul_lanes, batch, n, low, k, tcols_log, inverse, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
