// K6: the lane-wise sum of S stacks of window sums, (S, 3, C, 8, n), in one
// launch and one fixed tree order (the body and the order: point_sum.cuh).
//
// Replaces icicle_snark_tpu/ops/msm.py _acc_windows (:961), which the
// out-of-core MSM runs once a slice, and the mesh combine of
// icicle_snark_tpu/parallel/msm_shard.py:35-38 (ops/msm.py _tree_reduce
// :408). The port's callers (ops/msm.py msm_windows_sliced,
// parallel/msm_shard.py combine_windows) hand it every slice's or every
// shard's window sums at once.
//
// Bound: at the prove's n = G * W <= 80 lanes (G1 (4, 16), G2 (1, 16)) the
// bytes and the (S - 1) * 12 (G1) or 42 (G2) Fq products a lane cost next to
// nothing; the time is the launch and one lane's chain of dependent
// additions. The pairwise route paid S - 1 launches and S - 1 additions in a
// row; the tree pays one launch and log2 S additions, G2's on a thread pair.
#include "point_sum.cuh"

template <class L>
__global__ void point_sum_kernel(u32* __restrict__ out, const u32* __restrict__ in, long long s,
                                 long long n, int half, int lb) {
  extern __shared__ u32 sm[];
  point_sum_body<L>(out, in, s, n, half, lb, blockIdx.x, threadIdx.x, sm);
}

template <class L>
static int launch(u32* out, const u32* in, long long s, long long n, cudaStream_t st) {
  int half, lb;
  point_sum_shape(s, n, L::SHIFT, half, lb);
  const size_t smem = half > 1 ? (size_t)4 * half * L::W3 * lb : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(point_sum_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  point_sum_kernel<L><<<(unsigned)((n + lb - 1) / lb), (half << L::SHIFT) * lb, smem, st>>>(
      out, in, s, n, half, lb);
  return (int)cudaGetLastError();
}

// out (3, C, 8, n), in (s, 3, C, 8, n) limb-major, C = 1 (G1) or 2 (G2);
// 2 <= s <= 1024
extern "C" int snark_point_sum(int g2, void* out, const void* in, long long s, long long n,
                               void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (g2) return launch<SumG2Pair>((u32*)out, (const u32*)in, s, n, st);
  return launch<SumG1>((u32*)out, (const u32*)in, s, n, st);
}
