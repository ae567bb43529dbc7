// K4 reduce: the window sums sum_b b * B_b, b = 1..H, per (window, group)
// row, from the bucket sums of csrc/msm.cu, for G1 and G2.
//
// The BN254 instantiations and C entry of K4 reduce; the templates, their
// design and their bound are in msm_kernels.cuh.
//
// Replaces icicle_snark_tpu/ops/msm.py _telescope_batched (:701),
// _chunked_reduce (:368) and _scalar_double_k (:393).
#include "msm_kernels.cuh"

extern "C" int snark_msm_reduce(int g2, int stage, void* out, void* seg_s, void* seg_t,
                                const void* buckets, long long windows, long long groups,
                                long long half, long long seg, int nt, void* stream) {
  if (windows * groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2) return launch_reduce<E2>(stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
  return launch_reduce<E1>(stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
}
