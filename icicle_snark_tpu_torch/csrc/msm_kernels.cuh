// K4's templates over any point type E of curve.cuh or curve_n.cuh: the
// Pippenger bucket accumulation (msm_accumulate_kernel) and the window
// reduction (msm_reduce_segments_kernel, msm_reduce_rows_kernel), moved
// unchanged out of msm.cu and msm_reduce.cu. Those files instantiate them for
// BN254 (E1, E2) and keep K4's C entries; msm_bls12_377.cu, msm_bls12_381.cu
// and msm_bw6_761.cu instantiate them for the other curves' six point types
// (K13), one file a curve so that nvcc compiles them in parallel.
//
// ---------------------------------------------------------------- accumulate
// Pippenger bucket sums of a grouped MSM.
//
// Replaces icicle_snark_tpu/ops/msm.py _window_bucket_prefixes (:609),
// PrefixTree (:257), _chunked_inclusive_scan (:198) and the pipelines around
// them (:727, :790, :935, :943). The TPU had no scatter atomics and no
// per-lane control flow, so it summed buckets as prefix-sum differences of
// the sorted points. On Hopper a thread walks a run of sorted lanes.
//
// The lanes of each window arrive sorted by key = group * (H + 1) + |digit|
// (torch.sort in ops/msm.py), so bucket (window, group, b) is a run of
// consecutive sorted positions. ops/msm.py `bucket_fold_plan` cuts every run
// into pieces of at most L = BUCKET_PIECE positions (torch cumsum and
// repeat_interleave) and hands this kernel one table per level:
//   level 0:  one thread per piece mixed-adds the piece's affine points (y
//             negated for a negative digit), starting from the first point
//             (BN254 G2 in Jacobian coordinates, fq2_lazy.cuh, stored
//             homogeneous);
//   level >0: one thread per piece of the previous level's partial sums adds
//             them in order with complete projective adds,
// until every bucket has at most L inputs; that last level has one item per
// bucket (an empty bucket gives the identity) and writes the bucket sums,
// (3, coords..., W*G*H), bucket b at b - 1, which msm_reduce.cu reads.
//
// Longest serial chain per thread: L - 1 additions per level, over
// ceil(log_L(R)) levels for the longest run R (1 level when R <= L), so at
// most (L - 1) * ceil(log_L(R)) whatever the digits: a bit-valued witness,
// which puts half of all lanes into bucket 1 of window 0, only adds levels.
// The order of additions is fixed by the tables (no atomics on points), so
// every run gives the same words and the plain version mirrors them.
//
// Bound: operations, one mixed add per lane with a nonzero digit: 11 Fq
// products for G1; for G2's Jacobian level 0 29, 16 on a piece's first add,
// and 8 a store (profiling.py g2_level0_muls; the benchmark's roofline keeps
// RCB15's 39 as its fixed yardstick). chip_smoke.py counts them from the
// digits.
// What the design does about the old kernel's faults:
//   * thread per bucket, time set by the longest run: pieces of at most L;
//   * 16 or 32 scattered 32-byte sectors per limb-major point: points come
//     as lane-major records (64 bytes G1, 128 G2), read as 16-byte vectors;
//   * a __noinline__ mixed add whose 24/48-word operands went through the
//     call stack: the additions are force-inlined into the loop;
//   * canonical Fq arithmetic, a conditional subtraction after every
//     product, sum and difference and 9x as four doublings: BN254's loops
//     keep their coordinates lazy in [0, 2q) (fq_lazy.cuh, fq2_lazy.cuh),
//     canonical at the store;
//   * G2's 255 registers and 39 Fq products a mixed add: level 0 adds in
//     Jacobian coordinates, 29 Fq products and fewer live Fq2 values.
//
// ---------------------------------------------------------------- reduce
//
// Replaces icicle_snark_tpu/ops/msm.py _telescope_batched (:701),
// _chunked_reduce (:368) and _scalar_double_k (:393), which summed the
// buckets as a telescoped suffix reduction over the whole row.
//
// With segments of s = REDUCE_SEG buckets, S_j the sum of segment j and
// T_j = sum_i (i + 1) * B_{j*s + i} its local triangle (i = 0..s-1),
//     sum_b b * B_b = sum_j T_j + s * sum_j j * S_j.
// Two launches:
//   stage 0, segments: one thread per (row, segment), a running sum and a
//     running triangle from the segment's top bucket down: S_j and T_j.
//   stage 1, rows: one block of nt threads per row, thread u owning q =
//     n_seg / nt consecutive segments. It sums its S_j and its T_j; a
//     Hillis-Steele scan over the block gives every thread the sum of the
//     S_j above its own (its carry); starting from that carry, the thread
//     walks its segments from the top, and the running sum is then the
//     row's suffix sum Q_j = sum_{j' >= j} S_j', which it adds up for
//     j >= 1: sum_{j >= 1} Q_j = sum_j j * S_j. Two tree sums over the block
//     give A = sum_j T_j and V = sum_j j * S_j; thread 0 writes
//     A + 2^log2(s) * V, the one multiplication by s of the row
//     (log2 s doublings).
// Longest serial chain per thread, q = H / (s * nt): segments 2(s - 1)
// adds; rows 2(q - 1) adds for its S and T sums, log2(nt) scan steps, 2q
// adds of the walk, 2 log2(nt) tree steps, log2(s) doublings and one add. No thread walks the n_seg partials of a row and no segment is
// scaled by its offset, as the old kernel's 14-15-bit double-and-add did.
// The order of additions is fixed: the plain version mirrors it word for
// word. The segments stage adds in the lazy layer for BN254, as level 0 of
// the accumulate does; the rows stage keeps curve.cuh's canonical formulas.
//
// Bound: operations, 2(H - 1) complete adds per row (the running-sum
// triangle over all H buckets). This design does 2(H - n_seg) adds in the
// segments and about 4 n_seg + 3 nt + nt log2(nt) in the rows stage.
// Layouts (N the words of a coordinate component: 8 for BN254): buckets
// (3, C, N, rows*H); S and T (3, C, N, rows*n_seg); output (3, C, N, G, W),
// row w*G + g at g*W + w, like JAX's stacked window sums.
#pragma once
#include <type_traits>
#include "fq2_lazy.cuh"

// BN254's G1 and G2 run level 0 of the accumulate and the segments stage in
// the lazy layer (fq_lazy.cuh, fq2_lazy.cuh): every coordinate in [0, 2q)
// between additions and canonical at the store. G1's level 0 and the
// segments stage store the words of curve.cuh's formulas; G2's level 0 adds
// in Jacobian coordinates (k4_jacobian_item) and stores other words of the
// same points. G1 runs the fold levels lazy too; G2's fold levels keep
// curve.cuh's canonical add, since nvcc 12.8's cicc crashes (segmentation
// fault) on the lazy G2 add in that loop, though the same add builds in the
// segments stage. The other curves' point types (K13) keep
// their canonical formulas (curve_n.cuh).
template <class E>
inline constexpr bool k4_lazy = std::is_same_v<E, E1> || std::is_same_v<E, E2>;
template <class E>
inline constexpr bool k4_lazy_acc = std::is_same_v<E, E1>;

// p + (x, y), (x, y) a canonical record; (0, 0) is the identity
template <bool LAZY, class E>
__device__ __forceinline__ Pt<E> k4_madd(const Pt<E>& p, const E& x, const E& y) {
  if constexpr (LAZY) {
    if (e_is_zero(x) && e_is_zero(y)) return p;
    return lz_madd(p, x, y);
  } else {
    return p_madd(p, x, y);
  }
}

template <bool LAZY, class E>
__device__ __forceinline__ Pt<E> k4_add(const Pt<E>& p, const Pt<E>& q) {
  if constexpr (LAZY)
    return lz_padd(p, q);
  else
    return p_add_inl(p, q);
}

template <bool LAZY, class E>
__device__ __forceinline__ void k4_store(u32* base, long long n, long long i, const Pt<E>& p) {
  if constexpr (LAZY)
    p_store(base, n, i, lz_canon(p));
  else
    p_store(base, n, i, p);
}

// threads of an accumulate block, by instantiation (the sweep of PERF.md),
// and the resident blocks an SM asked of ptxas (0: none, no directive). G2's
// level 0 at 184 registers held two blocks of 128 threads an SM, as the
// RCB15 loop did at 255; asking for three caps it at 168 (40-44 B spilled)
// and took complex-1600k's G2 level 0 from 51.8 to 42.4-42.8 ms (PERF.md,
// the K4 row of the kernel table).
template <class E, bool AFF> struct AccThreads { static constexpr int N = 128, B = 0; };
template <> struct AccThreads<E1, true> { static constexpr int N = 512, B = 0; };
template <> struct AccThreads<E1, false> { static constexpr int N = 512, B = 0; };
template <> struct AccThreads<E2, true> { static constexpr int N = 128, B = 3; };

template <class E>
__device__ __forceinline__ void load_signed(E& x, E& y, const u32* __restrict__ rec,
                                            const int* __restrict__ order,
                                            const unsigned char* __restrict__ negs,
                                            long long pos) {
  rec_load(x, y, rec, order[pos]);
  if (negs[pos]) y = e_neg(y);
}

// Item i of BN254 G2's level 0, msm_accumulate_kernel<E2, true>'s body: the
// sum in Jacobian coordinates from Z = 0, the first record that is not
// (0, 0) starting it (fq2_lazy.cuh lz_jstep), stored homogeneous
// (lz_jac_to_proj).
__device__ __forceinline__ void k4_jacobian_item(u32* __restrict__ out,
                                                 const u32* __restrict__ src,
                                                 const int* __restrict__ order,
                                                 const unsigned char* __restrict__ negs,
                                                 const long long* __restrict__ start,
                                                 const int* __restrict__ len, long long n_items,
                                                 long long i) {
  long long st = start[i];
  int ln = len[i];
  Pt<E2> acc = p_identity<E2>();
  bool z1 = false;
  for (int r = 0; r < ln; r++) {
    E2 x, y;
    load_signed(x, y, src, order, negs, st + r);
    acc = lz_jstep(acc, z1, x, y);
  }
  p_store(out, n_items, i, lz_jac_to_proj(acc));
}

// AFF: src is the (total, words) record array, start[i] a flattened
// (window, sorted position) index into order/negs. Otherwise src is the
// previous level's (3, coords..., n_src) partial sums, start[i] an index into
// them. Item i adds len[i] inputs from start[i] on and writes out[i].
template <class E, bool AFF>
__global__ void __launch_bounds__((AccThreads<E, AFF>::N), (AccThreads<E, AFF>::B))
    msm_accumulate_kernel(u32* __restrict__ out, const u32* __restrict__ src, long long n_src,
                          const int* __restrict__ order, const unsigned char* __restrict__ negs,
                          const long long* __restrict__ start, const int* __restrict__ len,
                          long long n_items) {
  constexpr bool lazy = k4_lazy_acc<E>;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  if constexpr (std::is_same_v<E, E2> && AFF) {
    k4_jacobian_item(out, src, order, negs, start, len, n_items, i);
    return;
  }
  long long st = start[i];
  int ln = len[i];
  Pt<E> acc = p_identity<E>();
  if (ln > 0) {
    if constexpr (AFF) {
      E x, y;
      load_signed(x, y, src, order, negs, st);
      if (!(e_is_zero(x) && e_is_zero(y))) {
        acc.x = x;
        acc.y = y;
        e_set_one(acc.z);
      }
      for (int r = 1; r < ln; r++) {
        load_signed(x, y, src, order, negs, st + r);
        acc = k4_madd<lazy>(acc, x, y);
      }
    } else {
      acc = p_load<E>(src, n_src, st);
      for (int r = 1; r < ln; r++) acc = k4_add<lazy>(acc, p_load<E>(src, n_src, st + r));
    }
  }
  k4_store<lazy>(out, n_items, i, acc);
}

#define SEG_THREADS 128

template <class E>
__global__ void __launch_bounds__(SEG_THREADS)
    msm_reduce_segments_kernel(u32* __restrict__ seg_s, u32* __restrict__ seg_t,
                               const u32* __restrict__ buckets, long long rows, long long half,
                               long long seg) {
  long long n_seg = half / seg;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * n_seg) return;
  long long row = t / n_seg, j = t - row * n_seg;
  long long nb = rows * half;
  long long base = row * half + j * seg;
  Pt<E> run = p_load<E>(buckets, nb, base + seg - 1);
  Pt<E> tri = run;
  // for i = seg - 2 down to 0: run += B_i, then tri += run; one call site
  // of the inlined add, so the kernel holds one copy of it
  for (long long m = 0; m < 2 * (seg - 1); m++) {
    bool to_tri = m & 1;
    Pt<E> r = k4_add<k4_lazy<E>>(to_tri ? tri : run,
                                 to_tri ? run : p_load<E>(buckets, nb, base + seg - 2 - m / 2));
    if (to_tri)
      tri = r;
    else
      run = r;
  }
  k4_store<k4_lazy<E>>(seg_s, rows * n_seg, t, run);
  k4_store<k4_lazy<E>>(seg_t, rows * n_seg, t, tri);
}

// The launches and the rows stage; a host build (the tests) calls the two
// kernels above as functions, one thread at a time.
#ifdef __CUDACC__
template <class E, bool AFF>
static void launch_accumulate(void* out, const void* src, long long n_src, const void* order,
                              const void* negs, const void* start, const void* len,
                              long long n_items, cudaStream_t s) {
  constexpr int nt = AccThreads<E, AFF>::N;
  long long blocks = (n_items + nt - 1) / nt;
  msm_accumulate_kernel<E, AFF><<<blocks, nt, 0, s>>>(
      (u32*)out, (const u32*)src, n_src, (const int*)order, (const unsigned char*)negs,
      (const long long*)start, (const int*)len, n_items);
}

// most threads of a rows block (ops/msm.py REDUCE_BLOCK): 256 x 255 registers
// fill an SM's register file
#define ROWS_MAX_THREADS 256

// sum over the block of every thread's v, in a fixed tree order; the result
// is valid in thread 0. sh holds blockDim.x points.
template <class E>
__device__ Pt<E> block_sum(Pt<E>* sh, const Pt<E>& v, int u, int nt) {
  sh[u] = v;
  __syncthreads();
  for (int d = nt / 2; d >= 1; d >>= 1) {
    if (u < d) sh[u] = p_add(sh[u], sh[u + d]);
    __syncthreads();
  }
  Pt<E> r = sh[0];
  __syncthreads();
  return r;
}

template <class E>
__global__ void __launch_bounds__(ROWS_MAX_THREADS)
    msm_reduce_rows_kernel(u32* __restrict__ out, const u32* __restrict__ seg_s,
                           const u32* __restrict__ seg_t, long long windows, long long groups,
                           long long n_seg, int log_seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Pt<E>* sh = reinterpret_cast<Pt<E>*>(smem_raw);
  long long row = blockIdx.x;
  int nt = blockDim.x, u = threadIdx.x;
  long long rows = windows * groups, ns = rows * n_seg;
  long long q = n_seg / nt;
  long long first = row * n_seg + u * q;
  Pt<E> sig = p_load<E>(seg_s, ns, first), tau = p_load<E>(seg_t, ns, first);
  for (long long r = 1; r < q; r++) {
    sig = p_add(sig, p_load<E>(seg_s, ns, first + r));
    tau = p_add(tau, p_load<E>(seg_t, ns, first + r));
  }
  // inclusive suffix scan of sig over the block
  sh[u] = sig;
  __syncthreads();
  for (int d = 1; d < nt; d <<= 1) {
    Pt<E> v = sh[u];
    if (u + d < nt) v = p_add(v, sh[u + d]);
    __syncthreads();
    sh[u] = v;
    __syncthreads();
  }
  Pt<E> run = u + 1 < nt ? sh[u + 1] : p_identity<E>();
  __syncthreads();
  Pt<E> tri = p_identity<E>();
  for (long long r = q - 1; r >= 0; r--) {
    run = p_add(run, p_load<E>(seg_s, ns, first + r));
    if (u * q + r >= 1) tri = p_add(tri, run);
  }
  Pt<E> a = block_sum(sh, tau, u, nt);
  Pt<E> v = block_sum(sh, tri, u, nt);
  if (u == 0) {
    for (int k = 0; k < log_seg; k++) v = p_dbl(v);
    long long w = row / groups, g = row - w * groups;
    p_store(out, rows, g * windows + w, p_add(a, v));
  }
}

template <class E>
static int launch_reduce(int stage, void* out, void* seg_s, void* seg_t, const void* buckets,
                         long long windows, long long groups, long long half, long long seg,
                         int nt, cudaStream_t s) {
  long long rows = windows * groups;
  long long n_seg = half / seg;
  if (stage == 0) {
    long long blocks = (rows * n_seg + SEG_THREADS - 1) / SEG_THREADS;
    msm_reduce_segments_kernel<E><<<blocks, SEG_THREADS, 0, s>>>(
        (u32*)seg_s, (u32*)seg_t, (const u32*)buckets, rows, half, seg);
  } else {
    size_t shmem = (size_t)nt * sizeof(Pt<E>);
    if (shmem > 48 * 1024) {
      int err = (int)cudaFuncSetAttribute(msm_reduce_rows_kernel<E>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)shmem);
      if (err) return err;
    }
    int log_seg = 0;
    while ((1LL << log_seg) < seg) log_seg++;
    msm_reduce_rows_kernel<E><<<rows, nt, shmem, s>>>((u32*)out, (const u32*)seg_s,
                                                      (const u32*)seg_t, windows, groups, n_seg,
                                                      log_seg);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
