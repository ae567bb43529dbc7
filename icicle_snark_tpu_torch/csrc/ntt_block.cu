// K5: several radix-2 butterfly stages of the batched Fr NTT per launch,
// through shared memory, in place.
//
// Replaces icicle_snark_tpu/ops/mxu_ntt.py _ntt_mxu_jit (:350, with _ntt_rec
// :311, _dft_apply :197, _columns7_to_canonical :118) and
// prover/pipeline.py _coset_eval_mxu (:144): the large-domain transform the
// TPU ran as int8 Toeplitz matrix products. Only its result is kept. Here the
// large transform is the same radix-2 network as K3 (ntt.cu), cut into passes
// of k consecutive stages: a block gathers 2^k rows x T columns of one
// polynomial into shared memory, runs the k stages with __syncthreads()
// between them, and writes the tile back, so a transform costs
// ceil(log n / k)-odd passes over the batch instead of log n. Every stage's
// outputs are canonical, so the result equals K3 applied stage by stage word
// for word. The reorder-free pairing is K3's: inverse = Gentleman-Sande,
// natural in, bit-reversed out, 1/n fused into the stage of span 2; forward =
// Cooley-Tukey, bit-reversed in, natural out.
//
// A pass covers the stages of spans 2^(low+1) .. 2^(low+k). Element
// (row r, column c) of tile t of high block q is global index
//   i = (q << (low + k)) | (r << low) | (t * T + c),       T = 2^tcols_log,
// so neighbouring threads read neighbouring words of each limb row (T >= 32
// in the strided passes; the pass with low = 0 has T = 1 and rows themselves
// are neighbours). Shared memory is [limb][r * T + c]: a warp's 32 lanes fall
// on 32 banks while the paired rows are 32 or more elements apart; the last
// five stages of the low = 0 pass pair elements inside a warp's 32 and take
// 2-way bank conflicts, which this version accepts. Twiddles come from a
// STAGE-MAJOR (8, n) table in global memory: the stage of span m = 2^s keeps
// its m/2 twiddles w_m^0 .. w_m^(m/2-1) side by side from lane m/2 - 1, so a
// warp's loads are neighbours at every stage. (Gathered as tw[j * n / m] from
// the plain power table, as K3 does, every load below the top stages is a
// 32-byte sector of its own.) Index arithmetic is `long long`: a
// (3, 8, 2^22) batch passes 2^28 bytes.
//
// Bound on this card at (3, 8, 2^21): one transform is 2^20 * 21 * 3 = 66 M
// Montgomery products x 264 multiplies = 17.4 G, 1.04 ms at 16.7 T
// multiplies/s, against 0.12 ms for one pass over the 201 MB batch (read and
// write) at 3.35 TB/s. K3's 21 passes are bound by bytes (2.5 ms); K5's 4
// passes are bound by operations, and what keeps it from that bound is the
// CIOS product of field.cuh itself (carry chains around every multiply), not
// the memory system.
#include "field.cuh"

// 256 threads and at most 64 registers (four blocks of a 32 KB tile per SM):
// with 512 threads and the 120 registers the compiler takes unasked, one
// block filled an SM, and its loads, stages and stores ran one after the
// other with nothing else resident to overlap them.
#define NTT_BLOCK_THREADS 256

__global__ void __launch_bounds__(NTT_BLOCK_THREADS, 4)
    ntt_block_kernel(u32* __restrict__ x, const u32* __restrict__ tw,
                     const u32* __restrict__ scale, long long n, int log_n, int low, int k,
                     int tcols_log, int inverse) {
  extern __shared__ u32 sm[];
  const int T = 1 << tcols_log;
  const int E = 1 << (k + tcols_log);      // elements of the tile
  const long long tiles = (1LL << low) >> tcols_log;  // tiles per high block
  const long long per_poly = n >> (k + tcols_log);    // blocks per polynomial
  long long blk = blockIdx.x;
  long long bb = blk / per_poly, rest = blk - bb * per_poly;
  long long q = rest / tiles, t = rest - q * tiles;
  u32* xb = x + bb * 8 * n;
  const long long base = (q << (low + k)) | (t << tcols_log);

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int r = e >> tcols_log, c = e & (T - 1);
    long long i = base | ((long long)r << low) | c;
#pragma unroll
    for (int l = 0; l < 8; l++) sm[l * E + e] = xb[l * n + i];
  }
  __syncthreads();

  u32 s[8];
  if (scale) fload(s, scale, 1, 0);
  for (int step = 0; step < k; step++) {
    // local stage j pairs rows 2^(j-1) apart; its global span is 2^(low + j)
    const int j = inverse ? k - step : step + 1;
    const int hrow = 1 << (j - 1);
    for (int b = threadIdx.x; b < (E >> 1); b += blockDim.x) {
      int c = b & (T - 1), rb = b >> tcols_log;
      int jj = rb & (hrow - 1);
      int r0 = ((rb >> (j - 1)) << j) | jj;
      int e0 = (r0 << tcols_log) | c, e1 = e0 + (hrow << tcols_log);
      // position of the pair inside its span 2^(low + j); the stage-major
      // table holds that stage's half-span of twiddles from 2^(low+j-1) - 1
      long long pos = ((long long)jj << low) | (t << tcols_log) | c;
      long long ti = ((1LL << (low + j - 1)) - 1) + pos;
      u32 u[8], v[8], w[8], a[8], d[8];
#pragma unroll
      for (int l = 0; l < 8; l++) {
        u[l] = sm[l * E + e0];
        v[l] = sm[l * E + e1];
      }
      fload(w, tw, n, ti);
      if (inverse) {
        u32 df[8];
        fadd<Fr>(a, u, v);
        fsub<Fr>(df, u, v);
        fmul<Fr>(d, df, w);
        if (scale && low + j == 1) {
          fmul<Fr>(a, a, s);
          fmul<Fr>(d, d, s);
        }
      } else {
        u32 vw[8];
        fmul<Fr>(vw, v, w);
        fadd<Fr>(a, u, vw);
        fsub<Fr>(d, u, vw);
      }
#pragma unroll
      for (int l = 0; l < 8; l++) {
        sm[l * E + e0] = a[l];
        sm[l * E + e1] = d[l];
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int r = e >> tcols_log, c = e & (T - 1);
    long long i = base | ((long long)r << low) | c;
#pragma unroll
    for (int l = 0; l < 8; l++) xb[l * n + i] = sm[l * E + e];
  }
}

// One pass: stages of spans 2^(low+1) .. 2^(low+k) of every polynomial of
// x (batch, 8, n), tiles of 2^k rows x 2^tcols_log columns (tcols_log <= low).
extern "C" int snark_ntt_block(void* x, const void* tw, const void* scale, long long batch,
                               long long n, int log_n, int low, int k, int tcols_log,
                               int inverse, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (k < 1 || tcols_log < 0 || tcols_log > low || low + k > log_n || (1LL << log_n) != n)
    return (int)cudaErrorInvalidValue;
  int tile_log = k + tcols_log;
  size_t smem = (size_t)32 << tile_log;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ntt_block_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long half_tile = 1LL << (tile_log - 1);
  int threads = (int)(half_tile < NTT_BLOCK_THREADS ? (half_tile < 32 ? 32 : half_tile)
                                                    : NTT_BLOCK_THREADS);
  long long blocks = batch * (n >> tile_log);
  ntt_block_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (u32*)x, (const u32*)tw, (const u32*)scale, n, log_n, low, k, tcols_log, inverse);
  return (int)cudaGetLastError();
}
