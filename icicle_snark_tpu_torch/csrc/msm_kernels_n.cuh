// K13 reduce's rows stage for the other curves' six point types (bls12-377
// and bls12-381 G1 over a 12-word Fq, their G2 over Fq2, bw6-761 G1 and G2
// over a 24-word Fq): a tree over each (window, group) row's segments. The
// segments stage before it, and K13's accumulate, are K4's templates
// (msm_kernels.cuh) at curve_n.cuh's types; BN254's K4 keeps its rows stage.
//
// Replaces icicle_snark_tpu/ops/msm.py _telescope_batched (:701) and
// _chunked_reduce (:368), as icicle_snark_tpu/curves/device.py
// _window_sums_jit (:255) runs them over the curves' field tables.
//
// ---------------------------------------------------------------- design
// The window sum of a row of H buckets is sum_b (b + 1) B_b. K4's segments
// stage gives, per segment j of s buckets, S_j (its sum) and T_j (its local
// triangle, weights 1 ... s). For a run of buckets of length a, with T its
// local triangle and M = a * (its sum), two adjacent runs A (lower) and B
// (upper) give the run A B of length 2a with
//     T = T_A + T_B + M_B,   M = 2 (M_A + M_B):
// one doubling where a tree over suffix sums would multiply by a. One
// launch per level halves a row's runs, a thread per output run and role,
// T (two adds) or M (an add and a doubling), the roles in separate warps;
// the first level takes S and scales it (M_B = s S_B: log2 s doublings
// more in both roles); the last level writes T, the window sum, into
// (3, C, N, G, W) at g * W + w. The old rows stage was one block a row, 16
// to 24 blocks on 132 SMs, with a chain of about 50 adds a thread through
// the __noinline__ p_add (288-byte points by value, 1.4-3.9 KB of stack);
// here the first level has rows * H / 2s threads in each role and the chain
// is two operations a level over log2(H / s) levels. The order of
// additions is fixed (no atomics): ops/msm.py msm_reduce_n_plain mirrors it
// word for word.
//
// A point operation is a PROGRAM (ops/point_programs.py): steps dst = (a1
// [+ a2]) OP (b1 [+ b2]), OP a Montgomery product, an addition or a
// subtraction of one Fq value, the RCB15 formulas of curve.cuh (complete
// add alg 7, doubling alg 9) written out over Fq (Karatsuba for Fq2, small
// constants as addition chains). A thread walks the program with a loop;
// the operands come from the thread's SLOTS, a column of shared memory
// (slot s, word k at col[(s * N + k) * T]: a warp reads 32 consecutive
// words), constants from a block-wide table. So the kernel holds one inlined
// product (field_n.cuh nmul) and no point in registers. Blocks are
// MSMN_THREADS = 32 threads, whose slots are 19-42 KB of shared memory.
// Bound: operations.
#pragma once
#include "field_n.cuh"

#define MSMN_THREADS 32
#define MSMN_CONST 0xf0u
#define MSMN_NONE 0xffu
#define MSMN_PROGRAMS 2

// the programs of a group's table (ops/point_programs.py ADD, DBL)
enum { PROG_ADD = 0, PROG_DBL = 1 };

// the table's layout: n_consts constants of N words, then n_ops steps of
// two words; n_slots the slots a thread uses
struct MsmNMeta {
  int first[MSMN_PROGRAMS];
  int count[MSMN_PROGRAMS];
  int n_ops, n_consts, n_slots;
};

// One thread's slots, and the block's constants and program steps (step i
// at prog[2 * i]).
template <class F, int T>
struct Slots {
  static constexpr int N = F::N;
  u32* col;
  const u32* cst;
  const u32* prog;

  __device__ __forceinline__ void get(u32* x, u32 s) const {
    if (s >= MSMN_CONST) {
      const u32* c = cst + (s - MSMN_CONST) * N;
#pragma unroll
      for (int k = 0; k < N; k++) x[k] = c[k];
    } else {
      const u32* p = col + s * (N * T);
#pragma unroll
      for (int k = 0; k < N; k++) x[k] = p[k * T];
    }
  }

  __device__ __forceinline__ void put(u32 s, const u32* x) const {
    u32* p = col + s * (N * T);
#pragma unroll
    for (int k = 0; k < N; k++) p[k * T] = x[k];
  }

  // program `which` of the table: one step an iteration, so the loop body
  // holds the kernel's only product
  __device__ __forceinline__ void run(const MsmNMeta& m, int which) const {
    int end = m.first[which] + m.count[which];
#pragma unroll 1
    for (int i = m.first[which]; i < end; i++) {
      u32 w0 = prog[2 * i], w1 = prog[2 * i + 1];
      u32 x[N], y[N], z[N];
      get(x, (w0 >> 16) & 0xffu);
      if ((w1 & 0xffu) != MSMN_NONE) {
        get(z, w1 & 0xffu);
        nadd<F>(x, x, z);
      }
      get(y, w0 >> 24);
      if (((w1 >> 8) & 0xffu) != MSMN_NONE) {
        get(z, (w1 >> 8) & 0xffu);
        nadd<F>(y, y, z);
      }
      u32 op = w0 & 0xffu;
      if (op == 0)
        nmul<F>(x, x, y);
      else if (op == 1)
        nadd<F>(x, x, y);
      else
        nsub<F>(x, x, y);
      put((w0 >> 8) & 0xffu, x);
    }
  }
};

// Points in slots: coordinate j, component c at slot base + j * C + c (C = 1
// for Fq, 2 for Fq2). In global memory (3, C, N, n) limb-major: word k of
// lane i at ((j * C + c) * N + k) * n + i.
template <class F, int C, int T>
struct SlotPoint {
  static constexpr int N = F::N;

  static __device__ __forceinline__ void load(const Slots<F, T>& S, int base, const u32* src,
                                              long long n, long long i) {
#pragma unroll 1
    for (int q = 0; q < 3 * C; q++) {
      u32 x[N];
      const u32* p = src + (long long)q * N * n + i;
#pragma unroll
      for (int k = 0; k < N; k++) x[k] = p[(long long)k * n];
      S.put(base + q, x);
    }
  }

  static __device__ __forceinline__ void store(const Slots<F, T>& S, int base, u32* dst,
                                               long long n, long long i) {
#pragma unroll 1
    for (int q = 0; q < 3 * C; q++) {
      u32 x[N];
      S.get(x, base + q);
      u32* p = dst + (long long)q * N * n + i;
#pragma unroll
      for (int k = 0; k < N; k++) p[(long long)k * n] = x[k];
    }
  }

  static __device__ __forceinline__ void copy(const Slots<F, T>& S, int to, int from) {
#pragma unroll 1
    for (int q = 0; q < 3 * C; q++) {
      u32 x[N];
      S.get(x, from + q);
      S.put(to + q, x);
    }
  }
};

// ---------------------------------------------------------------- one thread's work
// P in slots [0, 3C), Q in [3C, 6C), a saved point in [6C, 9C), which the
// programs leave alone.

// Output run u of a tree level from runs a (lower) and a + 1 (upper) of the
// level's n_in input lanes. Role T: T_a + T_{a+1} + M_{a+1}; role M:
// 2 (M_a + M_{a+1}). With scale = log2 s > 0 (the first level) m_in holds
// the segments' sums S and M = s S: role T doubles S_{a+1} scale times,
// role M doubles S_a + S_{a+1} 1 + scale times. The last level writes T
// into the window sums.
template <class F, int C, int T>
__device__ __forceinline__ void msm_n_tree_item(const Slots<F, T>& S, const MsmNMeta& m,
                                                u32* out, u32* m_out, u32* t_out,
                                                const u32* m_in, const u32* t_in, long long n_in,
                                                long long a, bool role_m, int scale, long long u,
                                                long long n_out, bool last, long long rows,
                                                long long out_i) {
  using P = SlotPoint<F, C, T>;
  if (!role_m) {
    if (scale) {
      P::load(S, 0, m_in, n_in, a + 1);
      for (int k = 0; k < scale; k++) S.run(m, PROG_DBL);
      P::copy(S, 6 * C, 0);
    }
    P::load(S, 0, t_in, n_in, a);
    P::load(S, 3 * C, t_in, n_in, a + 1);
    S.run(m, PROG_ADD);
    if (scale)
      P::copy(S, 3 * C, 6 * C);
    else
      P::load(S, 3 * C, m_in, n_in, a + 1);
    S.run(m, PROG_ADD);
    if (last)
      P::store(S, 0, out, rows, out_i);
    else
      P::store(S, 0, t_out, n_out, u);
  } else {
    P::load(S, 0, m_in, n_in, a);
    P::load(S, 3 * C, m_in, n_in, a + 1);
    S.run(m, PROG_ADD);
    for (int k = 0; k <= scale; k++) S.run(m, PROG_DBL);
    P::store(S, 0, m_out, n_out, u);
  }
}

// The tree kernel's body for global thread t, after the block's table is in
// shared memory (tests/test_torch_msm_n_host_cuda.py calls it on the host).
template <class F, int C>
__device__ __forceinline__ void msm_n_tree_thread(const Slots<F, MSMN_THREADS>& S,
                                                  const MsmNMeta& m, long long t, u32* out,
                                                  u32* m_out, u32* t_out, const u32* m_in,
                                                  const u32* t_in, long long windows,
                                                  long long groups, long long n_in, int scale) {
  long long rows = windows * groups, n_out = n_in / 2, items = rows * n_out;
  bool last = n_out == 1;
  if (t >= (last ? items : 2 * items)) return;
  bool role_m = t >= items;
  long long u = role_m ? t - items : t;
  long long row = u / n_out, k = u - row * n_out;
  long long w = row / groups, g = row - w * groups;
  msm_n_tree_item<F, C, MSMN_THREADS>(S, m, out, m_out, t_out, m_in, t_in, rows * n_in,
                                      row * n_in + 2 * k, role_m, scale, u, items, last, rows,
                                      g * windows + w);
}

// Words of the block's shared table: the constants and the programs.
template <class F>
__host__ __device__ __forceinline__ int msm_n_table_words(const MsmNMeta& m) {
  return m.n_consts * F::N + 2 * m.n_ops;
}

#ifdef __CUDACC__
// ---------------------------------------------------------------- the kernel

template <class F, int C>
__global__ void __launch_bounds__(MSMN_THREADS)
    msm_n_reduce_tree_kernel(u32* __restrict__ out, u32* __restrict__ m_out,
                             u32* __restrict__ t_out, const u32* __restrict__ m_in,
                             const u32* __restrict__ t_in, long long windows, long long groups,
                             long long n_in, int scale, const u32* __restrict__ table,
                             MsmNMeta m) {
  extern __shared__ __align__(16) u32 msm_n_smem[];
  int nw = msm_n_table_words<F>(m);
  for (int w = threadIdx.x; w < nw; w += MSMN_THREADS) msm_n_smem[w] = table[w];
  __syncthreads();
  Slots<F, MSMN_THREADS> S;
  S.cst = msm_n_smem;
  S.prog = msm_n_smem + m.n_consts * F::N;
  S.col = msm_n_smem + nw + threadIdx.x;
  msm_n_tree_thread<F, C>(S, m, (long long)blockIdx.x * MSMN_THREADS + threadIdx.x, out, m_out,
                          t_out, m_in, t_in, windows, groups, n_in, scale);
}

// ---------------------------------------------------------------- launches

static inline MsmNMeta msm_n_meta(const int* v) {
  MsmNMeta m;
  for (int k = 0; k < MSMN_PROGRAMS; k++) {
    m.first[k] = v[k];
    m.count[k] = v[MSMN_PROGRAMS + k];
  }
  m.n_ops = v[2 * MSMN_PROGRAMS];
  m.n_consts = v[2 * MSMN_PROGRAMS + 1];
  m.n_slots = v[2 * MSMN_PROGRAMS + 2];
  return m;
}

template <class F>
static size_t msm_n_smem_bytes(const MsmNMeta& m) {
  return 4 * ((size_t)msm_n_table_words<F>(m) + (size_t)m.n_slots * F::N * MSMN_THREADS);
}

// Allow `bytes` of dynamic shared memory (above 48 KB only by attribute).
template <class K>
static int msm_n_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// One tree level over n_in runs a row (m_in: M, or S with scale = log2 s
// at the first level; t_in: T); the last level (n_in = 2) writes `out`.
template <class F, int C>
static int launch_reduce_tree_n(void* out, void* m_out, void* t_out, const void* m_in,
                                const void* t_in, long long windows, long long groups,
                                long long n_in, int scale, const void* table, const int* meta,
                                cudaStream_t s) {
  MsmNMeta m = msm_n_meta(meta);
  size_t shmem = msm_n_smem_bytes<F>(m);
  long long threads = windows * groups * (n_in / 2) * (n_in == 2 ? 1 : 2);
  long long blocks = (threads + MSMN_THREADS - 1) / MSMN_THREADS;
  int err = msm_n_allow_smem(msm_n_reduce_tree_kernel<F, C>, shmem);
  if (err) return err;
  msm_n_reduce_tree_kernel<F, C><<<blocks, MSMN_THREADS, shmem, s>>>(
      (u32*)out, (u32*)m_out, (u32*)t_out, (const u32*)m_in, (const u32*)t_in, windows, groups,
      n_in, scale, (const u32*)table, m);
  return (int)cudaGetLastError();
}

// Blocks of MSMN_THREADS the tree kernel fits on an SM at the meta's slots.
template <class F, int C>
static int msm_n_tree_occupancy(const int* meta) {
  MsmNMeta m = msm_n_meta(meta);
  size_t bytes = msm_n_smem_bytes<F>(m);
  int blocks = -1;
  if (msm_n_allow_smem(msm_n_reduce_tree_kernel<F, C>, bytes)) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, msm_n_reduce_tree_kernel<F, C>,
                                                    MSMN_THREADS, bytes))
    return -1;
  return blocks;
}
#endif
