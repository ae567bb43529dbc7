// K5: several radix-2 butterfly stages of the batched Fr NTT per launch (one
// pass), with the coset evaluation's elementwise work fused into the passes
// that end each transform.
//
// Replaces icicle_snark_tpu/ops/mxu_ntt.py _ntt_mxu_jit (:350, with _ntt_rec
// :311, _dft_apply :197, _columns7_to_canonical :118) and
// prover/pipeline.py _coset_eval_mxu (:144) with _h_from_odd_jit: the
// large-domain transform the TPU ran as int8 Toeplitz matrix products, the
// coset keys and h = (A B - C) R^2. Only the result is kept. The network is
// K3's radix-2 one (ntt.cu) with its reorder-free pairing: inverse =
// Gentleman-Sande, natural in, bit-reversed out; forward = Cooley-Tukey,
// bit-reversed in, natural out.
//
// A pass covers the stages of spans 2^(low+1) .. 2^(low+k) on tiles of 2^k
// rows x T = 2^tcols_log columns; element (row r, column c) of tile t of
// high block q is global index
//   i = (q << (low + k)) | (r << low) | (t * T + c).
// A block loads its tile into shared memory (limb-major, [limb][swz(e)],
// e = r * T + c; coalesced: neighbouring threads take neighbouring columns,
// or neighbouring rows when T = 1), runs the k stages, and writes it back.
// The stages go in pairs of row bits (bits 0-1, 2-3, ...; the DIF takes the
// pairs top down, an odd k ends in a single bit): each thread holds the four
// elements a pair mixes in registers and runs its four butterflies there,
// so a pass of k stages makes ceil(k / 2) shared-memory exchanges and
// barriers instead of k. Threads take the columns fastest, so a warp's 32
// lanes read 32 neighbouring words of each limb row when T >= 32. With
// T = 1 (the pass with low = 0) the lanes walk the rows that are not in the
// pair; swz() XORs a mask of tile bits 5-7 into the bank bits, chosen so
// that those lanes fall on 32 banks for every pair of bits below 5 (the
// higher pairs leave bits 0-4 to the lanes).
// Twiddles: the STAGE-MAJOR (8, n) table keeps, for the stage of span
// m = 2^s, w_m^0 .. w_m^(m/2-1) from lane m/2 - 1. The tile's stages need
// (2^k - 1) T of them: stage jb (row bit jb, span 2^(low+jb+1)) takes
// position (jj << low) | (t T + c) for jj < 2^jb and each column c. The
// block copies them into shared memory once, beside the tile and
// coalesced like it (entry ((2^jb - 1 + jj) << tc) | c, limb-major), so
// the butterflies read no twiddle from global memory; the pass's low = 0
// tile needs the same 2^k - 1 in every block, the others T per row.
//
// Field arithmetic is field_ptx.cuh's: lazy values in [0, 2r) inside the
// pass, canonical when written, so each pass's output equals the plain
// version (canonical after every stage) word for word. Modes:
//   PLAIN  the pass alone (ops/ntt.py ntt_block_plain);
//   SCALE  the last inverse pass (low = 0): each output times mul[i], a
//          constant (1/n for intt_dif) or the coset keys in bit-reversed
//          order with 1/n folded in (ZKeyCache.keys_br_scaled): one product
//          per output;
//   H      the last forward pass of the batch (A, B, C): one block holds
//          its tile of all three polynomials (two tile buffers, one set of
//          twiddles) and writes
//          h = (A B - C) * R^2 (mul = R^2) to out; x is not written.
// Index arithmetic is `long long`: a (3, 8, 2^22) batch passes 2^28 bytes.
//
// Bound on this card at (3, 8, 2^21): one transform is 2^20 * 21 * 3 = 66 M
// Montgomery products x 264 multiplies = 17.4 G, 1.04 ms at 16.7 T
// multiplies/s, against 0.12 ms for one pass over the 201 MB batch (read and
// write) at 3.35 TB/s: bound by operations.
#include "field_ptx.cuh"

// Threads of a block: one per pair item of a tile (2^10 / 4), at most
// NTT_THREADS; larger tiles loop. The launch bounds keep the registers under
// 65536 / (256 x 2); the build log (-Xptxas -v) shows the count and the
// spills. Shared memory: the tile and its twiddles, 64 bytes an element
// (96 for H's two tiles), so a tile of 2^11 elements is the largest.
#define NTT_SMEM_MAX (227 * 1024)
#define NTT_THREADS 256
#define NTT_MIN_BLOCKS 2

enum { PASS_PLAIN = 0, PASS_SCALE = 1, PASS_H = 2 };

// shared-memory word of tile element e inside a limb row: bits 0-4 XORed
// with 31 b5 ^ 26 b6 ^ 20 b7 of e, a bijection on each 32-element block
__device__ __forceinline__ int swz(int e) {
  return e ^ (-((e >> 5) & 1) & 31) ^ (-((e >> 6) & 1) & 26) ^ (-((e >> 7) & 1) & 20);
}

__device__ __forceinline__ void sload(u32 a[8], const u32* s, int E, int e) {
  const int w = swz(e);
#pragma unroll
  for (int l = 0; l < 8; l++) a[l] = s[l * E + w];
}

__device__ __forceinline__ void sstore(u32* s, int E, int e, const u32 a[8]) {
  const int w = swz(e);
#pragma unroll
  for (int l = 0; l < 8; l++) s[l * E + w] = a[l];
}

template <bool INV>
__device__ __forceinline__ void butterfly(u32 u[8], u32 v[8], const u32 w[8]) {
  u32 a[8], d[8];
  if (INV) {
    u32 df[8];
    fr_add2(a, u, v);
    fr_sub2(df, u, v);
    fr_mul(d, df, w);
  } else {
    u32 vw[8];
    fr_mul(vw, v, w);
    fr_add2(a, u, vw);
    fr_sub2(d, u, vw);
  }
#pragma unroll
  for (int l = 0; l < 8; l++) {
    u[l] = a[l];
    v[l] = d[l];
  }
}

// The G (1 or 2) stages of row bits j0 .. j0 + G - 1 on the tile s, with
// the tile's twiddles st. Item b: column c = b mod T and the row bits
// outside the group; its 2^G elements are rows r0 | (q << j0).
template <int G, bool INV>
__device__ __forceinline__ void stage_group(u32* s, const u32* st, int tc, int E, int j0) {
  const int T = 1 << tc;
  const int items = E >> G;
  for (int b = threadIdx.x; b < items; b += blockDim.x) {
    const int c = b & (T - 1), rb = b >> tc;
    const int below = rb & ((1 << j0) - 1);
    const int r0 = ((rb >> j0) << (j0 + G)) | below;
    u32 v[1 << G][8];
#pragma unroll
    for (int q = 0; q < (1 << G); q++) sload(v[q], s, E, ((r0 | (q << j0)) << tc) | c);
#pragma unroll
    for (int step = 0; step < G; step++) {
      const int sg = INV ? G - 1 - step : step;
      const int jb = j0 + sg;  // the stage pairs rows 2^jb apart: global span 2^(low + jb + 1)
#pragma unroll
      for (int lowv = 0; lowv < (1 << sg); lowv++) {
        // the pair's position inside its half span: its twiddle's entry
        const int jj = below | (lowv << j0);
        const int ti = (((1 << jb) - 1 + jj) << tc) | c;
        u32 w[8];
#pragma unroll
        for (int l = 0; l < 8; l++) w[l] = st[l * E + ti];
#pragma unroll
        for (int hv = 0; hv < (1 << (G - 1 - sg)); hv++) {
          const int q0 = lowv | (hv << (sg + 1));
          butterfly<INV>(v[q0], v[q0 | (1 << sg)], w);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < (1 << G); q++) sstore(s, E, ((r0 | (q << j0)) << tc) | c, v[q]);
  }
}

// All k stages of the tile, pair by pair (from bit 0 up; the DIF takes
// them top down), a barrier after each.
template <bool INV>
__device__ __forceinline__ void tile_stages(u32* s, const u32* st, int k, int tc, int E) {
  const int groups = (k + 1) / 2;
  for (int gi = 0; gi < groups; gi++) {
    const int j0 = 2 * (INV ? groups - 1 - gi : gi);
    if (k - j0 >= 2)
      stage_group<2, INV>(s, st, tc, E, j0);
    else
      stage_group<1, INV>(s, st, tc, E, j0);
    __syncthreads();
  }
}

__device__ __forceinline__ long long tile_index(long long base, int e, int low, int tc) {
  return base | ((long long)(e >> tc) << low) | (e & ((1 << tc) - 1));
}

// The tile's twiddles (header) into st: entry ((2^jb - 1 + jj) << tc) | c.
__device__ __forceinline__ void load_twiddles(u32* st, const u32* __restrict__ tw, long long n,
                                              int low, int k, int tc, long long t, int E) {
  const int count = ((1 << k) - 1) << tc;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int row = (e >> tc) + 1;  // 2^jb + jj
    const int jb = 31 - __clz(row);
    const long long lane = ((1LL << (low + jb)) - 1) + ((long long)(row - (1 << jb)) << low) +
                           ((t << tc) | (e & ((1 << tc) - 1)));
#pragma unroll
    for (int l = 0; l < 8; l++) st[l * E + e] = __ldg(tw + l * n + lane);
  }
}

// The tile into s; the barrier after it also covers load_twiddles.
__device__ __forceinline__ void load_tile(u32* s, const u32* __restrict__ xb, long long n,
                                          long long base, int low, int tc, int E) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const long long i = tile_index(base, e, low, tc);
    const int w = swz(e);
#pragma unroll
    for (int l = 0; l < 8; l++) s[l * E + w] = xb[l * n + i];
  }
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(NTT_THREADS, NTT_MIN_BLOCKS)
    ntt_block_kernel(u32* __restrict__ x, const u32* __restrict__ tw,
                     const u32* __restrict__ mul, long long mul_lanes, u32* __restrict__ out,
                     int batch, long long n, int low, int k, int tc, int inverse) {
  extern __shared__ u32 sm[];
  const int E = 1 << (k + tc);
  const long long tiles = (1LL << low) >> tc;  // tiles per high block
  long long tile = blockIdx.x, bb = 0;
  if (MODE != PASS_H) {
    bb = tile % batch;
    tile /= batch;
  }
  const long long q = tile / tiles, t = tile - q * tiles;
  const long long base = (q << (low + k)) | (t << tc);
  u32* st = sm + (MODE == PASS_H ? 16 : 8) * E;
  load_twiddles(st, tw, n, low, k, tc, t, E);

  if (MODE == PASS_H) {
    // A into the first buffer; B into the second, then A * B into the
    // first; C into the second, then h out. One set of twiddles serves all
    // three.
    u32* s0 = sm;
    u32* s1 = sm + 8 * E;
    u32 r2[8];
#pragma unroll
    for (int l = 0; l < 8; l++) r2[l] = mul[l];
    for (int p = 0; p < 3; p++) {
      u32* s = p == 0 ? s0 : s1;
      load_tile(s, x + p * 8 * n, n, base, low, tc, E);
      tile_stages<false>(s, st, k, tc, E);
      if (p == 0) continue;
      for (int e = threadIdx.x; e < E; e += blockDim.x) {
        u32 a[8], b[8], r[8];
        sload(a, s0, E, e);
        sload(b, s1, E, e);
        if (p == 1) {
          fr_mul(r, a, b);
          sstore(s0, E, e, r);
        } else {
          fr_sub2(r, a, b);
          fr_mul(a, r, r2);
          fr_canon(r, a);
          fstore(out, n, tile_index(base, e, low, tc), r);
        }
      }
      __syncthreads();
    }
    return;
  }

  u32* xb = x + bb * 8 * n;
  load_tile(sm, xb, n, base, low, tc, E);
  if (inverse)
    tile_stages<true>(sm, st, k, tc, E);
  else
    tile_stages<false>(sm, st, k, tc, E);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const long long i = tile_index(base, e, low, tc);
    u32 a[8], r[8];
    sload(a, sm, E, e);
    if (MODE == PASS_SCALE) {
      u32 m[8];
      fload(m, mul, mul_lanes, mul_lanes == 1 ? 0 : i);
      fr_mul(r, a, m);
      fr_canon(a, r);
    } else {
      fr_canon(a, a);
    }
    fstore(xb, n, i, a);
  }
}

template <int MODE>
static int launch_pass(u32* x, const u32* tw, const u32* mul, long long mul_lanes, u32* out,
                       long long batch, long long n, int low, int k, int tc, int inverse,
                       cudaStream_t stream) {
  const int tile_log = k + tc;
  const size_t smem = (size_t)(MODE == PASS_H ? 96 : 64) << tile_log;
  if (smem > NTT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ntt_block_kernel<MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long items = (1LL << tile_log) >> 2;
  const int threads = (int)(items < 32 ? 32 : (items > NTT_THREADS ? NTT_THREADS : items));
  long long blocks = (MODE == PASS_H ? 1 : batch) * (n >> tile_log);
  ntt_block_kernel<MODE><<<blocks, threads, smem, stream>>>(x, tw, mul, mul_lanes, out,
                                                            (int)batch, n, low, k, tc, inverse);
  return (int)cudaGetLastError();
}

// One pass: stages of spans 2^(low+1) .. 2^(low+k) of every polynomial of
// x (batch, 8, n), tiles of 2^k rows x 2^tcols_log columns (tcols_log <=
// low). mul NULL: PLAIN. mul (8, mul_lanes), out NULL: SCALE (inverse,
// low = 0; mul_lanes 1 or n). out (8, n): H (forward, batch 3, mul = R^2).
extern "C" int snark_ntt_block(void* x, const void* tw, const void* mul, long long mul_lanes,
                               void* out, long long batch, long long n, int log_n, int low, int k,
                               int tcols_log, int inverse, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (k < 1 || tcols_log < 0 || tcols_log > low || low + k > log_n || (1LL << log_n) != n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out) {
    if (inverse || batch != 3 || !mul) return (int)cudaErrorInvalidValue;
    return launch_pass<PASS_H>((u32*)x, (const u32*)tw, (const u32*)mul, 1, (u32*)out, batch, n,
                               low, k, tcols_log, 0, s);
  }
  if (mul) {
    if (!inverse || low != 0 || (mul_lanes != 1 && mul_lanes != n))
      return (int)cudaErrorInvalidValue;
    return launch_pass<PASS_SCALE>((u32*)x, (const u32*)tw, (const u32*)mul, mul_lanes, nullptr,
                                   batch, n, low, k, tcols_log, 1, s);
  }
  return launch_pass<PASS_PLAIN>((u32*)x, (const u32*)tw, nullptr, 0, nullptr, batch, n, low, k,
                                 tcols_log, inverse, s);
}
