// K13 for bls12-377: G1 over a 12-word Fq, G2 over Fq2 (u^2 = -5). The
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

extern "C" int snark_msm_accumulate_bls12_377(int g2, int affine, void* out, const void* src,
                                        long long n_src, const void* order, const void* negs,
                                        const void* start, const void* len, long long n_items,
                                        cudaStream_t s) {
  if (g2 && affine)
    launch_accumulate<E377_2, true>(out, src, n_src, order, negs, start, len, n_items, s);
  else if (g2)
    launch_accumulate<E377_2, false>(out, src, n_src, order, negs, start, len, n_items, s);
  else if (affine)
    launch_accumulate<E377, true>(out, src, n_src, order, negs, start, len, n_items, s);
  else
    launch_accumulate<E377, false>(out, src, n_src, order, negs, start, len, n_items, s);
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
extern "C" int snark_msm_reduce_bls12_377(int g2, int stage, void* out, void* m_out, void* t_out,
                                    const void* m_in, const void* t_in, long long windows,
                                    long long groups, long long n, long long k,
                                    const void* table, const int* meta, cudaStream_t s) {
  if (stage == 0)
    return g2 ? launch_segments_n<E377_2>(m_out, t_out, m_in, windows, groups, n, k, s)
              : launch_segments_n<E377>(m_out, t_out, m_in, windows, groups, n, k, s);
  if (g2)
    return launch_reduce_tree_n<Bls377Fq, 2>(out, m_out, t_out, m_in, t_in, windows, groups, n,
                                          (int)k, table, meta, s);
  return launch_reduce_tree_n<Bls377Fq, 1>(out, m_out, t_out, m_in, t_in, windows, groups, n, (int)k,
                                        table, meta, s);
}

extern "C" int snark_msm_tree_occupancy_bls12_377(int g2, const int* meta) {
  return g2 ? msm_n_tree_occupancy<Bls377Fq, 2>(meta) : msm_n_tree_occupancy<Bls377Fq, 1>(meta);
}
