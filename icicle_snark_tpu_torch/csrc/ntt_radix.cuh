// K3 (BN254 Fr) and K14's one-stage kernel (the other curves' Fr): a pass of
// r consecutive radix-2 butterfly stages of the batched NTT in registers, one
// template over both field layers. ntt.cu and ntt_n.cu hold only the C
// entries that instantiate it. The body is plain C++ once the CUDA
// qualifiers are defined away (tests/test_torch_ntt_radix_host_cuda.py runs
// every thread of a pass on the host); the kernels and their launch are
// under __CUDACC__.
//
// Replaces icicle_snark_tpu/ops/ntt.py intt_dif (:180) and ntt_dit (:158),
// the per-stage reshape + mont_mul/add_mod/sub_mod graphs XLA lowered for the
// TPU, below ops/ntt.py NTT_BLOCK_MIN_LOG (from it up K5 and K14's passes
// run) and on the forced routes that check those passes. The design before
// was one stage a launch: 2 log n launches a transform pair, each streaming
// the whole batch through device memory, and (K3) a twiddle gather from the
// natural power table, one 32-byte sector per word per thread in the middle
// spans.
//
// Pass (low, R) covers the spans 2^(low+1) .. 2^(low+R). Element
// i = (hi << (low + R)) | (t << low) | j, j < 2^low, t < 2^R, of one batch
// row: one thread owns the 2^R elements t of one (row, hi, j), loads them,
// runs the pass's R 2^(R-1) butterflies in registers and stores them. No
// shared memory and no barrier: a design independent of K5's and K14's
// shared-memory tiles, so that it stays their check. Consecutive threads
// take consecutive j, so from low = 3 up a group of 8 threads reads whole
// 32-byte sectors of each word row; in the first pass (low = 0) a thread's
// elements are consecutive in each word row and move as 16-byte vectors
// (8-byte at R = 1) when x is aligned for them.
//
// Butterflies: DIT forward in ascending stage order, (u + v w, u - v w); DIF
// inverse in descending order, (u + v, (u - v) w). The stage of span
// m = 2^(low+k+1) pairs t and t | 2^k and reads w_m^j' with
// j' = j + (t mod 2^k) 2^low: from the STAGE-MAJOR table (ops/ntt.py
// stage_major) at lane m/2 - 1 + j', consecutive across a warp; or, for K3's
// one-stage entry (snark_ntt_stage, the natural (8, n) power table), at
// lane j' n / m. `scale` (N words, one value) multiplies every output of an
// inverse pass: the 1/n, in its low = 0 pass (a forward pass ignores it, as
// the plain stage does).
//
// Field layers (A): RadixFr over field.cuh's Fr (fmul/fadd/fsub) and
// RadixN<F> over field_n.cuh's F (nmul/nadd/nsub), canonical after every
// operation, so a pass writes the words its R plain stages write (ops/ntt.py
// ntt_radix_n_plain). Values kept lazy in [0, 2p) inside a pass were timed
// too, and were level with canonical ones within 1.5 % either way on an H100
// once the product was out of line (PERF.md): not kept.
//
// The product is out of line (radix_mul_call, __noinline__, its operands by
// value in registers): a pass then holds one copy of it, not R 2^(R-1).
// Inlined, the straight-line code of R = 3 (12 products) or R = 4 (32) did
// not fit the instruction cache: on an H100 R = 3 took 7.4 ms for the BN254
// pair at (3, 8, 2^21) and 20.9 ms for the bw6-761 pair at 2^22, 5.0 and 7.7
// out of line (PERF.md), and nvcc took 4.5 minutes for ntt_n.cu.
// ops/ntt.py NTT_RADIX_LOG picks R by width from those sweeps.
//
// Bound (chip_smoke.py): operations, n/2 products a stage and n more for the
// scale, each N (4N + 1) 32-bit multiplies; a pass moves the batch in and
// out once and about as many twiddle words.
#pragma once
#include "field.cuh"
#include "field_n.cuh"

#define RADIX_THREADS 128

struct RadixFr {
  static constexpr int N = 8;
  static constexpr int R_MAX = 4;
  __device__ static __forceinline__ void mul(u32* r, const u32* a, const u32* b) {
    fmul<Fr>(r, a, b);
  }
  __device__ static __forceinline__ void add(u32* r, const u32* a, const u32* b) {
    fadd<Fr>(r, a, b);
  }
  __device__ static __forceinline__ void sub(u32* r, const u32* a, const u32* b) {
    fsub<Fr>(r, a, b);
  }
};

template <class F>
struct RadixN {
  static constexpr int N = F::N;
  static constexpr int R_MAX = F::N <= 8 ? 4 : 3;
  __device__ static __forceinline__ void mul(u32* r, const u32* a, const u32* b) {
    nmul<F>(r, a, b);
  }
  __device__ static __forceinline__ void add(u32* r, const u32* a, const u32* b) {
    nadd<F>(r, a, b);
  }
  __device__ static __forceinline__ void sub(u32* r, const u32* a, const u32* b) {
    nsub<F>(r, a, b);
  }
};

template <int N>
struct RadixVal {
  u32 v[N];
};

// one product out of line, by value
template <class A>
__device__ __noinline__ RadixVal<A::N> radix_mul_call(const RadixVal<A::N> a,
                                                      const RadixVal<A::N> b) {
  RadixVal<A::N> r;
  A::mul(r.v, a.v, b.v);
  return r;
}

template <class A>
__device__ __forceinline__ void radix_mul(u32* r, const u32* a, const u32* b) {
  RadixVal<A::N> x, y;
#pragma unroll
  for (int l = 0; l < A::N; l++) x.v[l] = a[l], y.v[l] = b[l];
  const RadixVal<A::N> z = radix_mul_call<A>(x, y);
#pragma unroll
  for (int l = 0; l < A::N; l++) r[l] = z.v[l];
}

template <class A, bool INV>
__device__ __forceinline__ void radix_butterfly(u32* u, u32* v, const u32* w) {
  constexpr int N = A::N;
  u32 a[N], d[N];
  if constexpr (INV) {
    u32 df[N];
    A::add(a, u, v);
    A::sub(df, u, v);
    radix_mul<A>(d, df, w);
  } else {
    u32 vw[N];
    radix_mul<A>(vw, v, w);
    A::add(a, u, vw);
    A::sub(d, u, vw);
  }
#pragma unroll
  for (int l = 0; l < N; l++) {
    u[l] = a[l];
    v[l] = d[l];
  }
}

// Thread g (< batch n / 2^R) of pass (low, R) over x (batch, N, n), in place.
// NATURAL: tw is the (N, n) power table, else the stage-major table. vec:
// the first pass (low = 0) on x aligned to 4 * min(2^R, 4) bytes.
template <class A, int R, bool INV, bool NATURAL>
__device__ __forceinline__ void ntt_radix_body(u32* x, const u32* __restrict__ tw,
                                               const u32* __restrict__ scale, long long n, int low,
                                               long long g, bool vec) {
  constexpr int N = A::N, E = 1 << R, VW = E < 4 ? E : 4;
  const long long j = g & ((1LL << low) - 1);
  const long long rest = g >> low, blocks = n >> (low + R);
  const long long b = rest / blocks, hi = rest - b * blocks;
  const long long base = (hi << (low + R)) | j;
  u32* xb = x + b * N * n;
  u32 v[E][N];
  if (vec) {
#pragma unroll
    for (int l = 0; l < N; l++) {
      const u32* row = xb + l * n + base;
#pragma unroll
      for (int q = 0; q < E; q += VW) {
        if constexpr (VW == 4) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(row + q);
          v[q][l] = w4.x, v[q + 1][l] = w4.y, v[q + 2][l] = w4.z, v[q + 3][l] = w4.w;
        } else {
          const uint2 w2 = *reinterpret_cast<const uint2*>(row + q);
          v[q][l] = w2.x, v[q + 1][l] = w2.y;
        }
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < E; t++)
#pragma unroll
      for (int l = 0; l < N; l++) v[t][l] = xb[l * n + base + ((long long)t << low)];
  }
#pragma unroll
  for (int step = 0; step < R; step++) {
    const int k = INV ? R - 1 - step : step;  // pairs t and t | 2^k: span 2^(low + k + 1)
#pragma unroll
    for (int tl = 0; tl < (1 << k); tl++) {
      const long long pos = j + ((long long)tl << low);
      const long long lane = NATURAL ? pos * (n >> (low + k + 1)) : (1LL << (low + k)) - 1 + pos;
      u32 w[N];
#pragma unroll
      for (int l = 0; l < N; l++) w[l] = tw[l * n + lane];
#pragma unroll
      for (int th = 0; th < (E >> (k + 1)); th++) {
        const int t0 = tl | (th << (k + 1));
        radix_butterfly<A, INV>(v[t0], v[t0 | (1 << k)], w);
      }
    }
  }
  if (INV && scale) {
    u32 s[N];
#pragma unroll
    for (int l = 0; l < N; l++) s[l] = scale[l];
#pragma unroll
    for (int t = 0; t < E; t++) radix_mul<A>(v[t], v[t], s);
  }
  if (vec) {
#pragma unroll
    for (int l = 0; l < N; l++) {
      u32* row = xb + l * n + base;
#pragma unroll
      for (int q = 0; q < E; q += VW) {
        if constexpr (VW == 4) {
          *reinterpret_cast<uint4*>(row + q) =
              uint4{v[q][l], v[q + 1][l], v[q + 2][l], v[q + 3][l]};
        } else {
          *reinterpret_cast<uint2*>(row + q) = uint2{v[q][l], v[q + 1][l]};
        }
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < E; t++)
#pragma unroll
      for (int l = 0; l < N; l++) xb[l * n + base + ((long long)t << low)] = v[t][l];
  }
}

#ifdef __CUDACC__
// the radix passes (stage-major table)
template <class A, int R, bool INV>
__global__ void __launch_bounds__(RADIX_THREADS)
    ntt_radix_kernel(u32* __restrict__ x, const u32* __restrict__ tw,
                     const u32* __restrict__ scale, long long threads, long long n, int low,
                     int vec) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < threads) ntt_radix_body<A, R, INV, false>(x, tw, scale, n, low, g, vec != 0);
}

// K3's one-stage entry: R = 1 over the natural power table
template <class A, bool INV>
__global__ void __launch_bounds__(RADIX_THREADS)
    ntt_stage_kernel(u32* __restrict__ x, const u32* __restrict__ tw,
                     const u32* __restrict__ scale, long long threads, long long n, int low,
                     int vec) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < threads) ntt_radix_body<A, 1, INV, true>(x, tw, scale, n, low, g, vec != 0);
}

// One pass (low, R) over every row of x (batch, N, n), in place, with the
// stage-major table, or (NATURAL, R = 1) the natural one.
template <class A, int R, bool NATURAL = false>
static int ntt_radix_launch(void* x, const void* tw, const void* scale, long long batch,
                            long long n, int low, int inverse, cudaStream_t s) {
  static_assert(!NATURAL || R == 1, "the natural table's kernel is R = 1");
  const long long threads = batch * (n >> R);
  if (threads == 0) return 0;
  constexpr int VW = (1 << R) < 4 ? (1 << R) : 4;
  const int vec = low == 0 && (reinterpret_cast<uintptr_t>(x) % (4 * VW)) == 0;
  const long long blocks = (threads + RADIX_THREADS - 1) / RADIX_THREADS;
  u32* xp = (u32*)x;
  const u32 *twp = (const u32*)tw, *sp = (const u32*)scale;
  if constexpr (NATURAL) {
    if (inverse)
      ntt_stage_kernel<A, true><<<blocks, RADIX_THREADS, 0, s>>>(xp, twp, sp, threads, n, low,
                                                                 vec);
    else
      ntt_stage_kernel<A, false><<<blocks, RADIX_THREADS, 0, s>>>(xp, twp, sp, threads, n, low,
                                                                  vec);
  } else {
    if (inverse)
      ntt_radix_kernel<A, R, true><<<blocks, RADIX_THREADS, 0, s>>>(xp, twp, sp, threads, n, low,
                                                                    vec);
    else
      ntt_radix_kernel<A, R, false><<<blocks, RADIX_THREADS, 0, s>>>(xp, twp, sp, threads, n, low,
                                                                     vec);
  }
  return (int)cudaGetLastError();
}

// log2 of n, or -1 when n is not a power of two
static inline int radix_log2(long long n) {
  if (n <= 0 || (n & (n - 1))) return -1;
  int l = 0;
  while ((1LL << l) < n) l++;
  return l;
}

// pass (low, r), 1 <= r <= A::R_MAX, on the stage-major table
template <class A>
static int ntt_radix_dispatch(void* x, const void* stw, const void* scale, long long batch,
                              long long n, int low, int r, int inverse, cudaStream_t s) {
  const int log_n = radix_log2(n);
  if (log_n < 0 || low < 0 || r < 1 || r > A::R_MAX || low + r > log_n)
    return (int)cudaErrorInvalidValue;
  switch (r) {
    case 1: return ntt_radix_launch<A, 1>(x, stw, scale, batch, n, low, inverse, s);
    case 2: return ntt_radix_launch<A, 2>(x, stw, scale, batch, n, low, inverse, s);
    case 3: return ntt_radix_launch<A, 3>(x, stw, scale, batch, n, low, inverse, s);
    default:
      if constexpr (A::R_MAX >= 4)
        return ntt_radix_launch<A, 4>(x, stw, scale, batch, n, low, inverse, s);
      return (int)cudaErrorInvalidValue;
  }
}

// the one-stage entries' span m as the pass (log2(m) - 1, 1)
static inline int radix_stage_low(long long n, long long m) {
  const int log_n = radix_log2(n), log_m = radix_log2(m);
  return (log_n < 1 || log_m < 1 || log_m > log_n) ? -1 : log_m - 1;
}
#endif
