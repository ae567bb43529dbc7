// K14's passes: several radix-2 butterfly stages of the batched NTT over the
// other curves' scalar fields in one launch, through shared memory and
// registers: bls12-377 Fr and bls12-381 Fr (8 words) and bw6-761 Fr
// (bls12-377's Fq, 12 words), field_n.cuh. This header is the per-thread
// body of ntt_block_n.cu's kernel, plain C++ once the CUDA qualifiers are
// defined away (tests/test_torch_reduce_ntt_host_cuda.py runs blocks of it
// on the host, a std::thread a thread).
//
// Replaces icicle_snark_tpu/ops/ntt.py ntt_dit (:158) and intt_dif (:180)
// over a non-BN254 FieldSpec (NTTDomain(log_n, spec, root_tower), :104) and
// ntt(spec=...) (:228), which K14's one-stage kernel (ntt_n.cu) ran one
// launch a stage: log2(n) round trips of the whole batch through device
// memory and a twiddle load from it per butterfly. ops/ntt.py `_inverse_`
// and `_forward_` take these passes from NTT_BLOCK_MIN_LOG up and keep the
// one-stage kernel below it and as the stage-by-stage check.
//
// The network, tiling and twiddle staging are K5's (ntt_block.cu) at N
// words. A pass covers the stages of spans 2^(low+1) .. 2^(low+k) on tiles
// of 2^k rows x T = 2^tc columns; element (row r, column c) of tile t of
// high block q is global index
//   i = (q << (low + k)) | (r << low) | (t * T + c).
// A block loads its tile into shared memory (limb-major, [word][swz(e)],
// e = r * T + c; neighbouring threads take neighbouring columns, or rows
// when T = 1), runs the k stages two row bits at a time (a thread holds the
// four elements a pair of stages mixes in registers; an odd k ends in one
// bit; the inverse takes the pairs top down), a barrier after each pair,
// and writes the tile back. Twiddles: the STAGE-MAJOR (N, n) table
// (ops/ntt.py stage_major) keeps, for the stage of span m = 2^s,
// w_m^0 .. w_m^(m/2-1) from lane m/2 - 1; the tile's (2^k - 1) T of them are
// copied into shared memory once a block (entry ((2^jb - 1 + jj) << tc) | c
// for row bit jb), so no butterfly reads device memory.
//
// Field arithmetic: with F::LAZY (4p < 2^(32 N): bls12-377 Fr, 2^252.2 in
// 256 bits; the bw6-761 Fr, 377 bits in 384) values stay in [0, 2p) inside a
// pass: the product is field_n.cuh's CIOS rounds without the final
// subtraction (a, b < 2p: the result is below a b / 2^(32 N) + p < 2p), a
// sum or difference one conditional -+ 2p. bls12-381 Fr has r = 2^254.86, so
// 4r > 2^256 and a lazy sum would carry out of its eight words: it runs
// field_n.cuh's canonical nmul / nadd / nsub. Every store is canonical, so
// a pass's output equals its plain version (ops/ntt.py ntt_block_n_plain,
// canonical after every stage) word for word. Modes:
//   PLAIN  the pass alone;
//   SCALE  the low = 0 pass of the inverse: each output times mul[i], an
//          (N, 1) constant (1/n for intt_dif) or an (N, n) table.
//
// Shared memory: the tile and its twiddles, 8N bytes an element: a 2^10
// tile takes 64 KB at 8 words and 96 KB at 12, a 2^11 tile 128 and 192 KB,
// of the 227 KB a block may hold. The tile is ops/ntt.py's NTT_N_TILE_LOG,
// 2^10 at both widths (two blocks an SM), the choice and its times in its
// comment.
//
// Bound (chip_smoke.py check_ntt_n): operations, n/2 products a stage and n
// more for the scale, each N (4N + 1) 32-bit multiplies; at 2^22 a pass
// moves the batch in and out once, a few tenths of a millisecond against
// the products' 0.7 (8 words) or 1.7 ms (12) a transform.
#pragma once
#include "field_n.cuh"

#define NTTN_THREADS 256

enum { NTTN_PLAIN = 0, NTTN_SCALE = 1 };

// Threads of a pass's block: one a pair item of the tile (2^tile_log / 4),
// 32 to NTTN_THREADS; larger tiles loop.
inline int nb_block_threads(int tile_log) {
  const long long items = (1LL << tile_log) >> 2;
  return (int)(items < 32 ? 32 : (items > NTTN_THREADS ? NTTN_THREADS : items));
}

// 2p, word i
template <class F>
__device__ __forceinline__ u32 nb_2p(int i) {
  return (F::p(i) << 1) | (i ? F::p(i - 1) >> 31 : 0u);
}

// a * b: lazy (a, b < 2p -> out < 2p) or canonical
template <class F>
__device__ __forceinline__ void nb_mul(u32* r, const u32* a, const u32* b) {
  if constexpr (F::LAZY) {
    u32 t[F::N + 2];
    nmont_rounds<F>(t, a, b);
#pragma unroll
    for (int j = 0; j < F::N; j++) r[j] = t[j];
  } else {
    nmul<F>(r, a, b);
  }
}

// a + b: lazy (a + b < 4p < 2^(32 N), then - 2p if >= 2p) or canonical
template <class F>
__device__ __forceinline__ void nb_add(u32* r, const u32* a, const u32* b) {
  if constexpr (F::LAZY) {
    constexpr int N = F::N;
    u32 s[N], d[N];
    u64 c = 0, borrow = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      u64 x = (u64)a[j] + b[j] + c;
      s[j] = (u32)x;
      c = x >> 32;
    }
#pragma unroll
    for (int j = 0; j < N; j++) {
      u64 x = (u64)s[j] - nb_2p<F>(j) - borrow;
      d[j] = (u32)x;
      borrow = (x >> 32) & 1;
    }
#pragma unroll
    for (int j = 0; j < N; j++) r[j] = borrow ? s[j] : d[j];
  } else {
    nadd<F>(r, a, b);
  }
}

// a - b: lazy (+ 2p on a borrow; the carry out of the top word cancels it)
// or canonical
template <class F>
__device__ __forceinline__ void nb_sub(u32* r, const u32* a, const u32* b) {
  if constexpr (F::LAZY) {
    constexpr int N = F::N;
    u32 d[N];
    u64 borrow = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      u64 x = (u64)a[j] - b[j] - borrow;
      d[j] = (u32)x;
      borrow = (x >> 32) & 1;
    }
    const u32 mask = borrow ? 0xffffffffu : 0u;
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      u64 x = (u64)d[j] + (nb_2p<F>(j) & mask) + c;
      r[j] = (u32)x;
      c = x >> 32;
    }
  } else {
    nsub<F>(r, a, b);
  }
}

// a < 2p -> a mod p
template <class F>
__device__ __forceinline__ void nb_canon(u32* r, const u32* a) {
  if constexpr (F::LAZY) {
    ncond_sub_p<F>(r, a, 0);
  } else {
#pragma unroll
    for (int j = 0; j < F::N; j++) r[j] = a[j];
  }
}

// shared-memory word of tile element e inside a word row: bits 0-4 XORed
// with 31 b5 ^ 26 b6 ^ 20 b7 of e (K5's swizzle: the lanes of a T = 1 pass
// fall on 32 banks)
__device__ __forceinline__ int nb_swz(int e) {
  return e ^ (-((e >> 5) & 1) & 31) ^ (-((e >> 6) & 1) & 26) ^ (-((e >> 7) & 1) & 20);
}

template <int N>
__device__ __forceinline__ void nb_sload(u32* a, const u32* s, int E, int e) {
  const int w = nb_swz(e);
#pragma unroll
  for (int l = 0; l < N; l++) a[l] = s[l * E + w];
}

template <int N>
__device__ __forceinline__ void nb_sstore(u32* s, int E, int e, const u32* a) {
  const int w = nb_swz(e);
#pragma unroll
  for (int l = 0; l < N; l++) s[l * E + w] = a[l];
}

template <class F, bool INV>
__device__ __forceinline__ void nb_butterfly(u32* u, u32* v, const u32* w) {
  constexpr int N = F::N;
  u32 a[N], d[N];
  if (INV) {
    u32 df[N];
    nb_add<F>(a, u, v);
    nb_sub<F>(df, u, v);
    nb_mul<F>(d, df, w);
  } else {
    u32 vw[N];
    nb_mul<F>(vw, v, w);
    nb_add<F>(a, u, vw);
    nb_sub<F>(d, u, vw);
  }
#pragma unroll
  for (int l = 0; l < N; l++) {
    u[l] = a[l];
    v[l] = d[l];
  }
}

// The G (1 or 2) stages of row bits j0 .. j0 + G - 1 on the tile s, with
// the tile's twiddles st. Item b: column c = b mod T and the row bits
// outside the group; its 2^G elements are rows r0 | (q << j0).
template <class F, int G, bool INV>
__device__ __forceinline__ void nb_stage_group(u32* s, const u32* st, int tc, int E, int j0,
                                               int tid, int nthreads) {
  constexpr int N = F::N;
  const int T = 1 << tc;
  const int items = E >> G;
  for (int b = tid; b < items; b += nthreads) {
    const int c = b & (T - 1), rb = b >> tc;
    const int below = rb & ((1 << j0) - 1);
    const int r0 = ((rb >> j0) << (j0 + G)) | below;
    u32 v[1 << G][N];
#pragma unroll
    for (int q = 0; q < (1 << G); q++) nb_sload<N>(v[q], s, E, ((r0 | (q << j0)) << tc) | c);
#pragma unroll
    for (int step = 0; step < G; step++) {
      const int sg = INV ? G - 1 - step : step;
      const int jb = j0 + sg;  // the stage pairs rows 2^jb apart: global span 2^(low + jb + 1)
#pragma unroll
      for (int lowv = 0; lowv < (1 << sg); lowv++) {
        // the pair's position inside its half span: its twiddle's entry
        const int jj = below | (lowv << j0);
        const int ti = (((1 << jb) - 1 + jj) << tc) | c;
        u32 w[N];
#pragma unroll
        for (int l = 0; l < N; l++) w[l] = st[l * E + ti];
#pragma unroll
        for (int hv = 0; hv < (1 << (G - 1 - sg)); hv++) {
          const int q0 = lowv | (hv << (sg + 1));
          nb_butterfly<F, INV>(v[q0], v[q0 | (1 << sg)], w);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < (1 << G); q++) nb_sstore<N>(s, E, ((r0 | (q << j0)) << tc) | c, v[q]);
  }
}

// All k stages of the tile, pair by pair (from bit 0 up; the inverse takes
// them top down), a barrier after each.
template <class F, bool INV>
__device__ __forceinline__ void nb_tile_stages(u32* s, const u32* st, int k, int tc, int E,
                                               int tid, int nthreads) {
  const int groups = (k + 1) / 2;
  for (int gi = 0; gi < groups; gi++) {
    const int j0 = 2 * (INV ? groups - 1 - gi : gi);
    if (k - j0 >= 2)
      nb_stage_group<F, 2, INV>(s, st, tc, E, j0, tid, nthreads);
    else
      nb_stage_group<F, 1, INV>(s, st, tc, E, j0, tid, nthreads);
    __syncthreads();
  }
}

__device__ __forceinline__ long long nb_index(long long base, int e, int low, int tc) {
  return base | ((long long)(e >> tc) << low) | (e & ((1 << tc) - 1));
}

// One block of a pass over x (batch, N, n): block = tile * batch + row.
// tw is the stage-major table; mul (N, mul_lanes) the SCALE factors; sm the
// block's shared memory, 8N << (k + tc) bytes.
template <class F, int MODE>
__device__ __forceinline__ void ntt_block_n_body(u32* x, const u32* __restrict__ tw,
                                                 const u32* __restrict__ mul, long long mul_lanes,
                                                 int batch, long long n, int low, int k, int tc,
                                                 bool inverse, u32* sm, long long block, int tid,
                                                 int nthreads) {
  constexpr int N = F::N;
  const int E = 1 << (k + tc);
  const long long tiles = (1LL << low) >> tc;  // tiles per high block
  const long long bb = block % batch, tile = block / batch;
  const long long q = tile / tiles, t = tile - q * tiles;
  const long long base = (q << (low + k)) | (t << tc);
  u32* st = sm + N * E;
  // the tile's twiddles: entry ((2^jb - 1 + jj) << tc) | c
  const int count = ((1 << k) - 1) << tc;
  for (int e = tid; e < count; e += nthreads) {
    const int row = (e >> tc) + 1;  // 2^jb + jj
    const int jb = 31 - __clz(row);
    const long long lane = ((1LL << (low + jb)) - 1) + ((long long)(row - (1 << jb)) << low) +
                           ((t << tc) | (e & ((1 << tc) - 1)));
#pragma unroll
    for (int l = 0; l < N; l++) st[l * E + e] = tw[l * n + lane];
  }
  u32* xb = x + bb * N * n;
  for (int e = tid; e < E; e += nthreads) {
    const long long i = nb_index(base, e, low, tc);
    const int w = nb_swz(e);
#pragma unroll
    for (int l = 0; l < N; l++) sm[l * E + w] = xb[l * n + i];
  }
  __syncthreads();
  if (inverse)
    nb_tile_stages<F, true>(sm, st, k, tc, E, tid, nthreads);
  else
    nb_tile_stages<F, false>(sm, st, k, tc, E, tid, nthreads);
  for (int e = tid; e < E; e += nthreads) {
    const long long i = nb_index(base, e, low, tc);
    u32 a[N], r[N];
    nb_sload<N>(a, sm, E, e);
    if (MODE == NTTN_SCALE) {
      u32 m[N];
      nload<F>(m, mul, mul_lanes, mul_lanes == 1 ? 0 : i);
      nb_mul<F>(r, a, m);
      nb_canon<F>(a, r);
      nstore<F>(xb, n, i, a);
    } else {
      nb_canon<F>(r, a);
      nstore<F>(xb, n, i, r);
    }
  }
}
