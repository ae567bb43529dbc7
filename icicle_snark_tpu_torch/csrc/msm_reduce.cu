// K4 reduce: the window sums sum_b b * B_b, b = 1..H, per (window, group)
// row, from the bucket sums of csrc/msm.cu, for G1 and G2.
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
// word.
//
// Bound: operations, 2(H - 1) complete adds per row (the running-sum
// triangle over all H buckets). This design does 2(H - n_seg) adds in the
// segments and about 4 n_seg + 3 nt + nt log2(nt) in the rows stage.
// Layouts: buckets (3, C, 8, rows*H); S and T (3, C, 8, rows*n_seg); output
// (3, C, 8, G, W), row w*G + g at g*W + w, like JAX's stacked window sums.
#include "curve.cuh"

#define SEG_THREADS 128
// most threads of a rows block (ops/msm.py REDUCE_BLOCK): 256 x 255 registers
// fill an SM's register file
#define ROWS_MAX_THREADS 256

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
    Pt<E> r = p_add_inl(to_tri ? tri : run,
                        to_tri ? run : p_load<E>(buckets, nb, base + seg - 2 - m / 2));
    if (to_tri)
      tri = r;
    else
      run = r;
  }
  p_store(seg_s, rows * n_seg, t, run);
  p_store(seg_t, rows * n_seg, t, tri);
}

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

extern "C" int snark_msm_reduce(int g2, int stage, void* out, void* seg_s, void* seg_t,
                                const void* buckets, long long windows, long long groups,
                                long long half, long long seg, int nt, void* stream) {
  if (windows * groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2) return launch_reduce<E2>(stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
  return launch_reduce<E1>(stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
}
