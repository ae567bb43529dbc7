// The Montgomery product over the last axis of (rows, N, n), one template
// for K10's product (field_reduce.cu, field.cuh's fmul at BN254 Fr and Fq)
// and K17's (field_reduce_n.cu, field_n.cuh's nmul at the two 8-word Fr).
// M is the field layer: M::N words, M::mul(r, a, b) a canonical product,
// M::one(k) the Montgomery one. This header is the per-thread body of both
// kernels, plain C++ once the CUDA qualifiers are defined away
// (tests/test_torch_reduce_ntt_host_cuda.py runs it on the host, a
// std::thread a thread).
//
// Replaces icicle_snark_tpu/ops/vec_ops.py product_reduce (:80): on the TPU a
// log-depth tree of full-width mont_mul graphs, one level per halving, the
// odd tail padded with the Montgomery one.
//
// Bound: operations, N (4N + 1) 32-bit multiplies a product and n - 1
// products a row (0.265 ms for a row of 2^24 at 8 words on an H100); the
// 32 bytes an element read are 0.16 ms. The block tree K10 and K17 ran
// before (8 192 blocks of 256 threads at 2^24, 8 elements a thread on one
// accumulator, then 8 tree levels through shared memory with a barrier
// each, one warp or less busy at the last five) paid about 15 serial
// product latencies for 2 048 products a block, and a load's latency
// before each product. Here:
//   * grid: a few blocks an SM, sized from the SM count (ops/vec_ops.py
//     product_blocks), split over the rows; each block folds one span of its
//     row, each thread a strided run of it (about 124 elements at 2^24),
//     loads coalesced (neighbouring threads, neighbouring lanes);
//   * a thread folds into ACC independent accumulators, element j of its
//     run into accumulator j mod ACC; the odd tail goes to the first ones,
//     and the accumulators merge pairwise;
//   * the thread stages its next ACC elements into shared memory by
//     cp.async while it multiplies the current ones (the same loads into
//     registers, one group ahead, were no faster: ptxas scheduled them
//     late);
//   * the block's threads merge by __shfl_down_sync inside each warp (five
//     levels, no barrier; every lane multiplies, lane i < d reads lane i + d,
//     which the level before left valid), then one shared-memory step: each
//     warp's lane 0 writes its product and warp 0 merges those the same way;
//   * each block writes one partial; the wrapper launches once more over
//     the partials, one block a row, when a row has several.
// Empty accumulators and lanes past the span hold the Montgomery one. The
// product of Montgomery values is associative and commutative and every
// step ends canonical, so any tree gives the plain version's (the JAX
// pairing's) words.
#pragma once

#define PRODUCT_THREADS 256
// Accumulators a thread. On an H100 a row of 2^24 took 0.52-0.54 ms at 2,
// 0.54-0.57 at 3 and 0.57-0.61 at 4, at 2-4 blocks an SM (PERF.md PR 11).
#define PRODUCT_ACC 2

// Dynamic shared memory of a block: the warps' products (N x 32 words) and
// two staged groups of ACC elements a thread.
constexpr int product_smem_bytes(int n_words, int acc) {
  return 4 * (n_words * 32 + 2 * acc * n_words * PRODUCT_THREADS);
}

// 4 bytes global -> shared by cp.async (no register holds them in flight);
// built for the host (the tests), a plain copy
__device__ __forceinline__ void product_stage4(u32* dst, const u32* src) {
#ifdef __CUDA_ARCH__
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

// Stage group b of this thread: elements start + q step, q < ACC, below hi,
// word k of element q at st[((b ACC + q) N + k) nthreads + tid]; then close
// the cp.async group (empty past the run).
template <int N, int ACC>
__device__ __forceinline__ void product_issue(u32* st, int b, const u32* base, long long n,
                                              long long start, long long step, long long hi,
                                              int tid, int nthreads) {
#pragma unroll
  for (int q = 0; q < ACC; q++) {
    const long long j = start + q * step;
    if (j < hi) {
#pragma unroll
      for (int k = 0; k < N; k++)
        product_stage4(st + ((b * ACC + q) * N + k) * nthreads + tid, base + k * n + j);
    }
  }
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// acc = the product of elements lo + tid, lo + tid + nthreads, ... below hi.
// The thread stages its next group of ACC elements into shared memory by
// cp.async before it multiplies the current one, so the loads' latency hides
// behind the products without holding registers; each thread reads only what
// it staged, so no barrier is needed.
template <class M, int ACC>
__device__ __forceinline__ void product_fold(u32* acc, const u32* base, long long n, long long lo,
                                             long long hi, int tid, int nthreads, u32* st) {
  constexpr int N = M::N;
  u32 a[ACC][N];
#pragma unroll
  for (int q = 0; q < ACC; q++)
#pragma unroll
    for (int k = 0; k < N; k++) a[q][k] = M::one(k);
  const long long step = nthreads, group = ACC * step;
  long long i = lo + tid;
  product_issue<N, ACC>(st, 0, base, n, i, step, hi, tid, nthreads);
  int b = 0;
#pragma unroll 1
  for (; i < hi; i += group, b ^= 1) {
    product_issue<N, ACC>(st, b ^ 1, base, n, i + group, step, hi, tid, nthreads);
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // all but the newest group
#endif
#pragma unroll
    for (int q = 0; q < ACC; q++) {
      if (i + q * step < hi) {
        u32 v[N];
#pragma unroll
        for (int k = 0; k < N; k++) v[k] = st[((b * ACC + q) * N + k) * nthreads + tid];
        M::mul(a[q], a[q], v);
      }
    }
  }
#pragma unroll
  for (int d = 1; d < ACC; d <<= 1)
#pragma unroll
    for (int q = 0; q + d < ACC; q += 2 * d) M::mul(a[q], a[q], a[q + d]);
#pragma unroll
  for (int k = 0; k < N; k++) acc[k] = a[0][k];
}

// Lane 0 ends with the product of the warp's lanes 0 .. 2 first - 1.
template <class M>
__device__ __forceinline__ void product_warp(u32* acc, int first) {
  constexpr int N = M::N;
  for (int d = first; d > 0; d >>= 1) {
    u32 o[N];
#pragma unroll
    for (int k = 0; k < N; k++) o[k] = __shfl_down_sync(0xffffffffu, acc[k], d);
    M::mul(acc, acc, o);
  }
}

// One block of a launch over in (rows, N, n) into out (rows, N, blocks):
// block = row * blocks + span. sm: product_smem_bytes(N, ACC) of shared
// memory; nthreads is a power of two from 32 to PRODUCT_THREADS.
template <class M, int ACC>
__device__ __forceinline__ void product_reduce_body(u32* out, const u32* in, long long n,
                                                    long long blocks, long long block, int tid,
                                                    int nthreads, u32* sm) {
  constexpr int N = M::N;
  const long long row = block / blocks, b = block - row * blocks;
  const long long chunk = (n + blocks - 1) / blocks;
  const long long lo = b * chunk, hi = lo + chunk < n ? lo + chunk : n;
  u32* sh = sm;
  u32 acc[N];
  product_fold<M, ACC>(acc, in + row * N * n, n, lo, hi, tid, nthreads, sm + N * 32);
  product_warp<M>(acc, 16);
  const int lane = tid & 31, warp = tid >> 5, warps = nthreads >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; k++) sh[k * 32 + warp] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; k++) acc[k] = lane < warps ? sh[k * 32 + lane] : M::one(k);
    product_warp<M>(acc, warps >> 1);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < N; k++) out[row * N * blocks + k * blocks + b] = acc[k];
    }
  }
}
