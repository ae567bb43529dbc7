// K13 for bls12-377: G1 over a 12-word Fq, G2 over Fq2 (u^2 = -5): K4's accumulate and reduce templates (msm_kernels.cuh)
// instantiated for the curve's two point types (curve_n.cuh). One file a
// curve, so that nvcc compiles the curves in parallel; msm_n.cu holds the C
// entries that choose the curve.
//
// Replaces icicle_snark_tpu/curves/device.py _window_sums_jit (:254), which
// ran icicle_snark_tpu/ops/msm.py msm_device_grouped (:727:
// _window_bucket_prefixes :609, _telescope_batched :701) over the curve's
// field tables. Bound: operations, one mixed add per lane with a nonzero
// digit (accumulate) and 2(H - 1) complete adds per (window, group) row
// (reduce), counted in field products by chip_smoke.py.
#include "curve_n.cuh"
#include "msm_kernels.cuh"

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

extern "C" int snark_msm_reduce_bls12_377(int g2, int stage, void* out, void* seg_s, void* seg_t,
                                const void* buckets, long long windows, long long groups,
                                long long half, long long seg, int nt, cudaStream_t s) {
  if (g2) return launch_reduce<E377_2>(stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
  return launch_reduce<E377>(stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, s);
}
