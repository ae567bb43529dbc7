// K13 for bw6-761: G1 and G2 (M-twist) both over a 24-word Fq. The
// accumulate and the reduce's segments stage are K4's templates
// (msm_kernels.cuh) at the curve's two point types (curve_n.cuh); the
// reduce's rows stage is the tree of msm_kernels_n.cuh at the curve's Fq,
// its point formulas the group's programs (ops/point_programs.py), handed
// in as `table` and `meta`. One file a curve, so that nvcc compiles the
// curves in parallel; msm_n.cu holds the C entries that choose the curve.
//
// Replaces icicle_snark_tpu/curves/device.py _window_sums_jit (:255), which
// ran icicle_snark_tpu/ops/msm.py msm_device_grouped (:727:
// _window_bucket_prefixes :609, _telescope_batched :701) over the curve's
// field tables. Bound: operations, one mixed add per lane with a nonzero
// digit (accumulate) and 2(H - 1) complete adds per (window, group) row
// (reduce), counted in field products by chip_smoke.py.
#include "curve_n.cuh"
#include "msm_kernels.cuh"
#include "msm_kernels_n.cuh"

extern "C" int snark_msm_accumulate_bw6_761(int g2, int affine, void* out, const void* src,
                                        long long n_src, const void* order, const void* negs,
                                        const void* start, const void* len, long long n_items,
                                        cudaStream_t s) {
  if (g2 && affine)
    launch_accumulate<E761_2, true>(out, src, n_src, order, negs, start, len, n_items, s);
  else if (g2)
    launch_accumulate<E761_2, false>(out, src, n_src, order, negs, start, len, n_items, s);
  else if (affine)
    launch_accumulate<E761, true>(out, src, n_src, order, negs, start, len, n_items, s);
  else
    launch_accumulate<E761, false>(out, src, n_src, order, negs, start, len, n_items, s);
  return (int)cudaGetLastError();
}

template <class E>
static int launch_segments_n(void* seg_s, void* seg_t, const void* buckets, long long windows,
                    long long groups, long long half, long long seg, cudaStream_t s) {
  long long rows = windows * groups;
  long long blocks = (rows * (half / seg) + SEG_THREADS - 1) / SEG_THREADS;
  msm_reduce_segments_kernel<E><<<blocks, SEG_THREADS, 0, s>>>(
      (u32*)seg_s, (u32*)seg_t, (const u32*)buckets, rows, half, seg);
  return (int)cudaGetLastError();
}

// stage 0: K4's segments stage, (S, T) of each segment of k buckets of the
// (3, coords, rows * n) buckets in m_in, into m_out and t_out; stage 1: one
// tree level over n runs a row (m_in, t_in), k the first level's scale
extern "C" int snark_msm_reduce_bw6_761(int g2, int stage, void* out, void* m_out, void* t_out,
                                    const void* m_in, const void* t_in, long long windows,
                                    long long groups, long long n, long long k,
                                    const void* table, const int* meta, cudaStream_t s) {
  if (stage == 0)
    return g2 ? launch_segments_n<E761_2>(m_out, t_out, m_in, windows, groups, n, k, s)
              : launch_segments_n<E761>(m_out, t_out, m_in, windows, groups, n, k, s);
  // both groups are over Fq: one tree kernel, their programs differ (b3 = -3, 12)
  return launch_reduce_tree_n<Bw6Fq, 1>(out, m_out, t_out, m_in, t_in, windows, groups, n, (int)k,
                                        table, meta, s);
}

extern "C" int snark_msm_tree_occupancy_bw6_761(int g2, const int* meta) {
  (void)g2;
  return msm_n_tree_occupancy<Bw6Fq, 1>(meta);
}
