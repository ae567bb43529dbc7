// K15: the four-step NTT's twiddle pass over one shard of a device mesh
// (the body, its layouts and its design: four_step.cuh).
//
// Replaces icicle_snark_tpu/parallel/ntt_dist.py:70-75 (step 2 of
// ntt_four_step_partial: the gather tw_full[:, k1 * i2 % n] and its
// mont_mul) with the layout changes around it (:64-68, :77-84), which XLA
// lowered for the TPU. The power tables replace the JAX package's gather
// from the full n-entry table, whose neighbouring lanes read i2 apart.
//
// Bound: (1 + 1 / B) Montgomery products per element (264 32-bit
// multiplies each) against 64 bytes moved; at B = 3 and Fr on an H100 the
// two limits are within 10% of each other, operations the larger. So the
// loads have to overlap the products: each thread stages its element's
// batch rows by cp.async, forms its twiddle while they land, and multiplies
// each row as it arrives.
//
// Tiles (k1 x i2_loc): 0: 32 x 8, 1: 32 x 16, 2: 64 x 8 (ntt_dist.py
// FOUR_STEP_TILES, the chip script's sweep). On an H100 32 x 8 was the
// fastest by 25-30 %, at as many blocks an SM as its 74 registers allow
// (fewer, forced by padding the shared memory, were slower; PERF.md, Findings).
#include "four_step.cuh"

template <int TK1, int TI2>
__global__ void __launch_bounds__(TK1 * TI2)
    four_step_twiddle_kernel(u32* __restrict__ out, const u32* __restrict__ x,
                             const u32* __restrict__ tlo, const u32* __restrict__ thi,
                             long long batch, long long n1, long long n2_loc, long long d,
                             long long shard, int s_log) {
  extern __shared__ u32 st[];
  four_step_body<TK1, TI2>(out, x, tlo, thi, batch, n1, n2_loc, d, shard, s_log, blockIdx.x,
                           blockIdx.y, threadIdx.x, st);
}

template <int TK1, int TI2>
static int launch(u32* out, const u32* x, const u32* tlo, const u32* thi, long long batch,
                  long long n1, long long n2_loc, long long d, long long shard, int s_log,
                  cudaStream_t st) {
  auto kernel = four_step_twiddle_kernel<TK1, TI2>;
  const int rows = batch < FS_ROWS ? (int)batch : FS_ROWS;
  const size_t smem = 4 * (size_t)four_step_smem_words<TK1, TI2>(rows);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((n1 + TK1 - 1) / TK1), (unsigned)((n2_loc + TI2 - 1) / TI2));
  kernel<<<grid, TK1 * TI2, smem, st>>>(out, x, tlo, thi, batch, n1, n2_loc, d, shard, s_log);
  return (int)cudaGetLastError();
}

// out, x, tlo, thi and (batch, n1, n2_loc, d, shard, s_log) as in
// four_step.cuh; tile as above.
extern "C" int snark_four_step(void* out, const void* x, const void* tlo, const void* thi,
                               long long batch, long long n1, long long n2_loc, long long d,
                               long long shard, int s_log, int tile, void* stream) {
  if (batch == 0 || n1 == 0 || n2_loc == 0) return 0;
  u32* o = (u32*)out;
  const u32 *xp = (const u32*)x, *lo = (const u32*)tlo, *hi = (const u32*)thi;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 0: return launch<32, 8>(o, xp, lo, hi, batch, n1, n2_loc, d, shard, s_log, st);
    case 1: return launch<32, 16>(o, xp, lo, hi, batch, n1, n2_loc, d, shard, s_log, st);
    case 2: return launch<64, 8>(o, xp, lo, hi, batch, n1, n2_loc, d, shard, s_log, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
