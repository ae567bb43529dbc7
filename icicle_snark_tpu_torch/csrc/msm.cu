// K4: Pippenger bucket accumulation and window reduction for the grouped
// G1 MSM (Fq coordinates) and the G2 MSM (Fq2 coordinates).
//
// Replaces icicle_snark_tpu/ops/msm.py _window_bucket_prefixes (:609),
// PrefixTree (:257), _chunked_inclusive_scan (:198), _telescope_batched
// (:701), _chunked_reduce/_scalar_double_k (:368/:393) and the pipelines
// around them (:727, :790, :935, :943). The TPU version had no scatter
// atomics and no per-lane control flow, so it summed buckets as prefix-sum
// differences of the sorted points. On Hopper a thread can walk its own run:
//
//   accumulate: one thread per (window, group, bucket b >= 1). The lanes of
//     each window arrive sorted by key = group * (H + 1) + |digit| (torch.sort
//     in the wrapper), ends[w][key] = lanes with key <= key. The thread mixed-
//     adds the affine points of its run, y negated where the digit was
//     negative. Bound: operations (one mixed add per lane per window).
//   reduce: sum_b b * bucket_b per (window, group). The bucket range is cut
//     into segments of `seg` buckets, one thread each: a running-sum triangle
//     over the segment gives sum (b - lo + 1) * B_b, the segment's start is
//     added back as (lo - 1) * sum B_b by double-and-add; a second kernel,
//     one thread per (window, group), sums the segments in order.
//     Bound: operations, 2(H - 1) general adds per (window, group) (the
//     running-sum triangle over all H buckets); the segment scalings are
//     the price of the parallel split, not part of the bound.
//
// Layouts: affine points (C, 8, total) per coordinate (C = 1 for G1, 2 for
// G2); buckets (3, C, 8, W*G*H); output (3, C, 8, G, W) like JAX's stacked
// window sums.
#include "curve.cuh"

template <class E>
__global__ void msm_accumulate_kernel(u32* __restrict__ buckets, const u32* __restrict__ px,
                                      const u32* __restrict__ py, const int* __restrict__ order,
                                      const unsigned char* __restrict__ negs,
                                      const int* __restrict__ ends, long long total,
                                      long long windows, long long groups, long long half) {
  long long n_buckets = windows * groups * half;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_buckets) return;
  long long w = t / (groups * half);
  long long rem = t - w * groups * half;
  long long g = rem / half;
  long long b = rem - g * half + 1;
  long long key = g * (half + 1) + b;
  const int* ew = ends + w * groups * (half + 1);
  int lo = ew[key - 1], hi = ew[key];
  const int* ow = order + w * total;
  const unsigned char* nw = negs + w * total;
  Pt<E> acc = p_identity<E>();
  for (int j = lo; j < hi; j++) {
    long long lane = ow[j];
    E x, y;
    e_load(x, px, total, lane);
    e_load(y, py, total, lane);
    if (nw[j]) y = e_neg(y);
    acc = p_madd(acc, x, y);
  }
  p_store(buckets, n_buckets, t, acc);
}

template <class E>
__global__ void msm_reduce_segments_kernel(u32* __restrict__ partial,
                                           const u32* __restrict__ buckets, long long wg,
                                           long long half, long long seg, int nbits) {
  long long n_seg = half / seg;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= wg * n_seg) return;
  long long row = t / n_seg, s = t - row * n_seg;
  long long n_buckets = wg * half;
  long long lo = s * seg + 1;
  Pt<E> run = p_identity<E>(), tri = p_identity<E>();
  for (long long b = lo + seg - 1; b >= lo; b--) {
    Pt<E> bk = p_load<E>(buckets, n_buckets, row * half + (b - 1));
    run = p_add(run, bk);
    tri = p_add(tri, run);
  }
  // + (lo - 1) * run, double-and-add over a fixed bit count
  long long k = lo - 1;
  Pt<E> acc = p_identity<E>();
  for (int bit = nbits - 1; bit >= 0; bit--) {
    acc = p_dbl(acc);
    if ((k >> bit) & 1) acc = p_add(acc, run);
  }
  p_store(partial, wg * n_seg, t, p_add(tri, acc));
}

template <class E>
__global__ void msm_reduce_final_kernel(u32* __restrict__ out, const u32* __restrict__ partial,
                                        long long windows, long long groups, long long n_seg) {
  long long wg = windows * groups;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= wg) return;
  Pt<E> acc = p_identity<E>();
  for (long long s = 0; s < n_seg; s++) acc = p_add(acc, p_load<E>(partial, wg * n_seg, t * n_seg + s));
  long long w = t / groups, g = t - w * groups;
  p_store(out, wg, g * windows + w, acc);
}

extern "C" int snark_msm_accumulate(int g2, void* buckets, const void* px, const void* py,
                                    const void* order, const void* negs, const void* ends,
                                    long long total, long long windows, long long groups,
                                    long long half, void* stream) {
  long long n = windows * groups * half;
  if (n == 0) return 0;
  int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    msm_accumulate_kernel<E2><<<blocks, threads, 0, s>>>(
        (u32*)buckets, (const u32*)px, (const u32*)py, (const int*)order,
        (const unsigned char*)negs, (const int*)ends, total, windows, groups, half);
  else
    msm_accumulate_kernel<E1><<<blocks, threads, 0, s>>>(
        (u32*)buckets, (const u32*)px, (const u32*)py, (const int*)order,
        (const unsigned char*)negs, (const int*)ends, total, windows, groups, half);
  return (int)cudaGetLastError();
}

extern "C" int snark_msm_reduce(int g2, void* out, void* partial, const void* buckets,
                                long long windows, long long groups, long long half,
                                long long seg, int nbits, void* stream) {
  long long wg = windows * groups;
  if (wg == 0) return 0;
  long long n_seg = half / seg;
  int threads = 64;
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks1 = (wg * n_seg + threads - 1) / threads;
  long long blocks2 = (wg + threads - 1) / threads;
  if (g2) {
    msm_reduce_segments_kernel<E2><<<blocks1, threads, 0, s>>>((u32*)partial, (const u32*)buckets,
                                                              wg, half, seg, nbits);
    int err = (int)cudaGetLastError();
    if (err) return err;
    msm_reduce_final_kernel<E2><<<blocks2, threads, 0, s>>>((u32*)out, (const u32*)partial,
                                                           windows, groups, n_seg);
  } else {
    msm_reduce_segments_kernel<E1><<<blocks1, threads, 0, s>>>((u32*)partial, (const u32*)buckets,
                                                              wg, half, seg, nbits);
    int err = (int)cudaGetLastError();
    if (err) return err;
    msm_reduce_final_kernel<E1><<<blocks2, threads, 0, s>>>((u32*)out, (const u32*)partial,
                                                           windows, groups, n_seg);
  }
  return (int)cudaGetLastError();
}
