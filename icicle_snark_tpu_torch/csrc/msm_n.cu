// K13's C entries: the MSM accumulate and reduce of bls12-377 (curve 0),
// bls12-381 (1) and bw6-761 (2), each a call into that curve's file
// (msm_bls12_377.cu, msm_bls12_381.cu, msm_bw6_761.cu). Arguments as K4's
// (msm.cu, msm_reduce.cu), with the curve first; g2 selects the group.
#include <cuda_runtime.h>

#define MSM_N_CURVES(X) X(bls12_377) X(bls12_381) X(bw6_761)
#define DECLARE(c)                                                                      \
  extern "C" int snark_msm_accumulate_##c(int, int, void*, const void*, long long,      \
                                          const void*, const void*, const void*,        \
                                          const void*, long long, cudaStream_t);        \
  extern "C" int snark_msm_reduce_##c(int, int, void*, void*, void*, const void*,       \
                                      long long, long long, long long, long long, int, \
                                      cudaStream_t);
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

extern "C" int snark_msm_reduce_n(int curve, int g2, int stage, void* out, void* seg_s,
                                  void* seg_t, const void* buckets, long long windows,
                                  long long groups, long long half, long long seg, int nt,
                                  void* stream) {
  if (windows * groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case 0: return snark_msm_reduce_bls12_377(g2, stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
    case 1: return snark_msm_reduce_bls12_381(g2, stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
    case 2: return snark_msm_reduce_bw6_761(g2, stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
