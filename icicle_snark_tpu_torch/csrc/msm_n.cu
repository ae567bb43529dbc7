// K13's C entries: the MSM accumulate and reduce of bls12-377 (curve 0),
// bls12-381 (1) and bw6-761 (2), each a call into that curve's file
// (msm_bls12_377.cu, msm_bls12_381.cu, msm_bw6_761.cu). The accumulate's
// arguments are K4's (msm.cu) with the curve first; g2 selects the group.
#include <cuda_runtime.h>

#define MSM_N_CURVES(X) X(bls12_377) X(bls12_381) X(bw6_761)
#define DECLARE(c)                                                                          \
  extern "C" int snark_msm_accumulate_##c(int, int, void*, const void*, long long,          \
                                          const void*, const void*, const void*,            \
                                          const void*, long long, cudaStream_t);            \
  extern "C" int snark_msm_reduce_##c(int, int, void*, void*, void*, const void*,           \
                                      const void*, long long, long long, long long,         \
                                      long long, const void*, const int*, cudaStream_t);    \
  extern "C" int snark_msm_tree_occupancy_##c(int, const int*);
MSM_N_CURVES(DECLARE)

extern "C" int snark_msm_accumulate_n(int curve, int g2, int affine, void* out, const void* src,
                                      long long n_src, const void* order, const void* negs,
                                      const void* start, const void* len, long long n_items,
                                      void* stream) {
  if (n_items == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case 0: return snark_msm_accumulate_bls12_377(g2, affine, out, src, n_src, order, negs, start, len, n_items, s);
    case 1: return snark_msm_accumulate_bls12_381(g2, affine, out, src, n_src, order, negs, start, len, n_items, s);
    case 2: return snark_msm_accumulate_bw6_761(g2, affine, out, src, n_src, order, negs, start, len, n_items, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// stage 0: the segments of k buckets of the (3, coords, rows * n) buckets in
// m_in, their sums into m_out and triangles into t_out; stage 1: one tree
// level over n runs a row (m_in, t_in) into m_out, t_out, or, at n = 2, the
// (3, coords, G, W) window sums `out`; k the level's scale (log2 of the
// segment at the first level, else 0). table, meta: the group's programs
// (ops/point_programs.py) on the card and as 7 host ints.
extern "C" int snark_msm_reduce_n(int curve, int g2, int stage, void* out, void* m_out,
                                  void* t_out, const void* m_in, const void* t_in,
                                  long long windows, long long groups, long long n, long long k,
                                  const void* table, const void* meta, void* stream) {
  if (windows * groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* m = (const int*)meta;
  switch (curve) {
    case 0: return snark_msm_reduce_bls12_377(g2, stage, out, m_out, t_out, m_in, t_in, windows, groups, n, k, table, m, s);
    case 1: return snark_msm_reduce_bls12_381(g2, stage, out, m_out, t_out, m_in, t_in, windows, groups, n, k, table, m, s);
    case 2: return snark_msm_reduce_bw6_761(g2, stage, out, m_out, t_out, m_in, t_in, windows, groups, n, k, table, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of 32 threads an SM holds of the tree kernel at the meta's slots;
// -1 on an error
extern "C" int snark_msm_n_occupancy(int curve, int g2, const void* meta) {
  const int* m = (const int*)meta;
  switch (curve) {
    case 0: return snark_msm_tree_occupancy_bls12_377(g2, m);
    case 1: return snark_msm_tree_occupancy_bls12_381(g2, m);
    case 2: return snark_msm_tree_occupancy_bw6_761(g2, m);
    default: return -1;
  }
}
