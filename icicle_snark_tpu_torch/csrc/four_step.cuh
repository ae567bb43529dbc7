// K15's per-block body: the four-step NTT's twiddle pass over one tile of a
// shard (four_step.cu). Plain C++ once the CUDA qualifiers are defined away:
// tests/test_torch_sharded_kernels_host_cuda.py runs it on the host, a
// std::thread a thread, a std::barrier for __syncthreads and cp.async a copy
// before its wait.
//
// x is one shard's column-NTT output, (B, n2_loc, 8, n1): row (b, i2_loc)
// holds the column over k1, limb-major. Each element is multiplied by
// w^(k1 * i2), i2 = shard * n2_loc + i2_loc, and written to out as
// (d, B, n1 / d, 8, n2_loc), each destination's block [b][k1_loc][word]
// [i2_loc]. w^e = thi[e >> s] * tlo[e & (2^s - 1)], the tables lane-major
// ((2^s, 8) and (n / 2^s, 8), ntt_dist.py twiddle_tables); k1 * i2 < n, so
// no reduction mod n.
//
// A block is a tile of TK1 k1 by TI2 i2_loc, one thread an element. The
// parent kernel loaded each batch row's element, waited for it, multiplied,
// and passed two barriers, row after row, with its twiddle gathered word by
// word from limb-major tables. Here:
//   * at block start every thread issues cp.async for its own element's 8
//     words of every row (up to FS_ROWS rows a round), one commit group a
//     row; a warp's threads copy neighbouring k1, 128 bytes a word;
//   * while they land it reads its two table entries as four 16-byte loads
//     (the parent's 16 scattered word loads made the most L1 requests of
//     the pass) and forms its twiddle, lazy in [0, 2r): BN254 r has
//     4r < 2^256, so the product of the canonical x by it is below 1.5 r,
//     and field.cuh's fmul makes that canonical;
//   * it multiplies row b as soon as row b's group has landed
//     (cp.async.wait_group), in place: it reads only the words it copied,
//     so no barrier stands before a product;
//   * one barrier, then the transposing writes, TI2 words along i2_loc a run.
// A staged row is [word][TI2][TK1 + FS_PAD]: with FS_PAD = 4 the transposed
// reads (thread t reads i2 t mod TI2, k1 t / TI2) hit 32 distinct banks at
// TI2 = 8.
#pragma once
#include "field.cuh"

#define FS_PAD 4
#define FS_ROWS 4  // batch rows staged a round

template <int TK1, int TI2>
constexpr int four_step_smem_words(int rows) {
  return rows * 8 * TI2 * (TK1 + FS_PAD);
}

// 4 bytes global -> shared by cp.async, zero-filled when !in (built for the
// host, a plain copy)
__device__ __forceinline__ void fs_stage(u32* dst, const u32* src, bool in) {
#ifdef __CUDA_ARCH__
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
#else
  *dst = in ? *src : 0u;
#endif
}

__device__ __forceinline__ void fs_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most `pending` (< FS_ROWS) of this thread's groups are in flight
__device__ __forceinline__ void fs_wait(int pending) {
#ifdef __CUDA_ARCH__
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
#endif
}

// field.cuh's CIOS product without its final subtraction: a, b < r gives
// a b / R + r < 1.25 r
__device__ __forceinline__ void fr_mul_lazy(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      u64 s = (u64)a[j] * b[i] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[8] + c;
    t[8] = (u32)s;
    t[9] = (u32)(s >> 32);
    u32 m = t[0] * Fr::N0;
    s = (u64)m * Fr::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (u64)m * Fr::p(j) + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[8] + c;
    t[7] = (u32)s;
    t[8] = t[9] + (u32)(s >> 32);
  }
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = t[j];
}

// one lane-major table entry (8 words, its row 16-byte aligned)
__device__ __forceinline__ void fs_entry(u32 v[8], const u32* table, long long i) {
  const uint4* p = reinterpret_cast<const uint4*>(table + i * 8);
  const uint4 a = p[0], b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Tile (bx, by) of the pass, thread t of TK1 * TI2; st: the block's
// four_step_smem_words(min(batch, FS_ROWS)) words of shared memory.
template <int TK1, int TI2>
__device__ __forceinline__ void four_step_body(u32* out, const u32* x, const u32* tlo,
                                               const u32* thi, long long batch, long long n1,
                                               long long n2_loc, long long d, long long shard,
                                               int s_log, long long bx, long long by, int t,
                                               u32* st) {
  constexpr int ROW = TK1 + FS_PAD, WORD = TI2 * ROW, ROWS = 8 * WORD;
  const long long k1_0 = bx * TK1, i2_0 = by * TI2, n1_loc = n1 / d;
  // this thread's product: (i2_0 + ty, k1_0 + tx); its writes: (k1_0 + wk, i2_0 + wi)
  const int tx = t % TK1, ty = t / TK1, wi = t % TI2, wk = t / TI2;
  const long long k1 = k1_0 + tx, i2l = i2_0 + ty, k1w = k1_0 + wk, i2w = i2_0 + wi;
  const bool in = k1 < n1 && i2l < n2_loc, in_w = k1w < n1 && i2w < n2_loc;
  const long long dst = k1w / n1_loc, k1l = k1w - dst * n1_loc;
  u32* mine = st + ty * ROW + tx;
  u32 f[8];
  for (long long b0 = 0; b0 < batch; b0 += FS_ROWS) {
    const int rows = batch - b0 < FS_ROWS ? (int)(batch - b0) : FS_ROWS;
    for (int b = 0; b < rows; b++) {
      const u32* src = in ? x + ((b0 + b) * n2_loc + i2l) * 8 * n1 + k1 : x;
#pragma unroll
      for (int w = 0; w < 8; w++)
        fs_stage(mine + b * ROWS + w * WORD, src + (in ? w * n1 : 0), in);
      fs_commit();
    }
    if (b0 == 0 && in) {
      u32 lo[8], hi[8];
      const long long e = k1 * (shard * n2_loc + i2l);
      fs_entry(lo, tlo, e & ((1ll << s_log) - 1));
      fs_entry(hi, thi, e >> s_log);
      fr_mul_lazy(f, hi, lo);
    }
    for (int b = 0; b < rows; b++) {
      fs_wait(rows - 1 - b);
      if (in) {
        u32 v[8], r[8];
#pragma unroll
        for (int w = 0; w < 8; w++) v[w] = mine[b * ROWS + w * WORD];
        fmul<Fr>(r, v, f);
#pragma unroll
        for (int w = 0; w < 8; w++) mine[b * ROWS + w * WORD] = r[w];
      }
    }
    __syncthreads();
    if (in_w) {
      for (int b = 0; b < rows; b++) {
        u32* o = out + ((dst * batch + b0 + b) * n1_loc + k1l) * 8 * n2_loc;
        const u32* e = st + b * ROWS + wi * ROW + wk;
#pragma unroll
        for (int w = 0; w < 8; w++) o[w * n2_loc + i2w] = e[w * WORD];
      }
    }
    if (b0 + FS_ROWS < batch) __syncthreads();  // the next round overwrites the tile
  }
}
