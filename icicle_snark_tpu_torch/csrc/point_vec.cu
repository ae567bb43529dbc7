// K6: lane-wise complete projective addition of two stacked point arrays.
//
// Replaces icicle_snark_tpu/ops/msm.py _acc_windows (:961): the out-of-core
// MSM adds each slice's window sums onto the running ones, (3, 8, G, W) for
// G1 and (3, 2, 8, G, W) for G2. One thread per lane runs p_add (RCB15
// algorithm 7, curve.cuh), the formula of the plain version jcurve.padd, so
// the words are equal; it is complete, so identities (z = 0) on either side
// pass through (a group with no lane in a slice contributes exact
// identities).
//
// Bound: at the prove's G * W <= 80 lanes this is one partly filled warp or
// three: the launch itself (microseconds) is the cost, not the 12 (G1) or 42
// (G2) Fq products per lane nor the 3 * 96 (192) bytes per lane. It exists so
// that the accumulation stays on the device between slices.
#include "curve.cuh"

template <class E>
__global__ void point_add_kernel(u32* __restrict__ out, const u32* __restrict__ a,
                                 const u32* __restrict__ b, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<E> p = p_load<E>(a, n, i);
  Pt<E> q = p_load<E>(b, n, i);
  p_store(out, n, i, p_add(p, q));
}

// out, a, b: (3, C, 8, n) limb-major, C = 1 (G1) or 2 (G2)
extern "C" int snark_point_add(int g2, void* out, const void* a, const void* b, long long n,
                               void* stream) {
  if (n == 0) return 0;
  int threads = 64;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    point_add_kernel<E2><<<blocks, threads, 0, s>>>((u32*)out, (const u32*)a, (const u32*)b, n);
  else
    point_add_kernel<E1><<<blocks, threads, 0, s>>>((u32*)out, (const u32*)a, (const u32*)b, n);
  return (int)cudaGetLastError();
}
