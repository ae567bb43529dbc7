// K4 accumulate: Pippenger bucket sums for the grouped G1 MSM (Fq
// coordinates) and the G2 MSM (Fq2 coordinates) of BN254. The window
// reduction, K4's other half, is csrc/msm_reduce.cu.
//
// The BN254 instantiations and C entry of K4 accumulate; the template, its
// design and its bound are in msm_kernels.cuh.
//
// Replaces icicle_snark_tpu/ops/msm.py _window_bucket_prefixes (:609),
// PrefixTree (:257), _chunked_inclusive_scan (:198) and the pipelines around
// them (:727, :790, :935, :943).
#include "msm_kernels.cuh"

extern "C" int snark_msm_accumulate(int g2, int affine, void* out, const void* src,
                                    long long n_src, const void* order, const void* negs,
                                    const void* start, const void* len, long long n_items,
                                    void* stream) {
  if (n_items == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2 && affine)
    launch_accumulate<E2, true>(out, src, n_src, order, negs, start, len, n_items, s);
  else if (g2)
    launch_accumulate<E2, false>(out, src, n_src, order, negs, start, len, n_items, s);
  else if (affine)
    launch_accumulate<E1, true>(out, src, n_src, order, negs, start, len, n_items, s);
  else
    launch_accumulate<E1, false>(out, src, n_src, order, negs, start, len, n_items, s);
  return (int)cudaGetLastError();
}
