// K7: the two per-lane chains of MSM base precompute.
//
// Replaces icicle_snark_tpu/ops/msm.py precompute_bases (:431) with
// to_affine_device (:414), and fields/limbs.py mont_pow_const / mont_inv /
// batch_inv (:516/:541/:546) as they are used there and in
// setup/fast_setup.py _to_affine_bytes: the shifted base copies
// 2^(c * wp * m) * P of the proving key, stored affine.
//
//   point_dbl_k:     k complete doublings of each projective point (RCB15
//                    algorithm 9 in a loop). z = 0 stays z = 0. G1: one
//                    thread a lane (curve.cuh p_dbl). G2: a lane on a pair
//                    of threads, each holding one Fq component of x, y and z
//                    (curve_pair.cuh pair_dbl, inlined: one call site), so
//                    the 48-word point stays in registers across the loop.
//   point_to_affine: a batched inverse over L lanes a thread, as the TPU
//                    version's batch_inv (affine_batch.cuh): one Fermat
//                    inversion a thread instead of one a lane. z = 0 gives
//                    (0, 0), the affine encoding of infinity. L is chosen
//                    from n (affine_lanes).
//
// Projective results of the same formulas and affine coordinates are unique
// canonical words, so both entries equal their plain versions (jcurve.pdbl
// looped, jcurve.to_affine_plain) word for word.
//
// Bound: operations. G2 at complex-100k with (c, f) = (13, 4): shift = 65
// doublings x 27 Fq products (the Karatsuba count; the pair does 32, two
// squares at one product a thread) a lane and copy, against 384 bytes a lane;
// point_to_affine's in affine_batch.cuh. Registers and spills of each kernel
// are printed by -Xptxas -v at build.
#include "affine_batch.cuh"
#include "curve_pair.cuh"

__global__ void point_dbl_k_kernel(u32* __restrict__ out, const u32* __restrict__ in,
                                   long long n, int k) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<E1> p = p_load<E1>(in, n, i);
#pragma unroll 1
  for (int s = 0; s < k; s++) p = p_dbl(p);
  p_store(out, n, i, p);
}

// G2: threads 2i and 2i + 1 hold lane i's c0 and c1 components
__global__ void point_dbl_k_pair_kernel(u32* __restrict__ out, const u32* __restrict__ in,
                                        long long n, int k) {
  long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  if (i >= n) return;  // both threads of a pair
  PairLane pl = pair_lane();
  Pt<E1> p = pair_load(in, n, i, pl);
#pragma unroll 1
  for (int s = 0; s < k; s++) p = pair_dbl(p, pl);
  pair_store(out, n, i, pl, p);
}

template <class E, int L>
__global__ void point_to_affine_kernel(u32* __restrict__ ox, u32* __restrict__ oy,
                                       const u32* __restrict__ in, long long n) {
  long long T = (n + L - 1) / L;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  affine_batch_thread<E, L>(ox, oy, in, n, t, T);
}

// out, in: (3, C, 8, n)
extern "C" int snark_point_dbl_k(int g2, void* out, const void* in, long long n, int k,
                                 void* stream) {
  if (n == 0) return 0;
  int threads = 128;
  long long nthreads = g2 ? 2 * n : n;  // G2: a pair of threads a lane
  long long blocks = (nthreads + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    point_dbl_k_pair_kernel<<<blocks, threads, 0, s>>>((u32*)out, (const u32*)in, n, k);
  else
    point_dbl_k_kernel<<<blocks, threads, 0, s>>>((u32*)out, (const u32*)in, n, k);
  return (int)cudaGetLastError();
}

template <class E>
static void affine_launch(int lanes, u32* ox, u32* oy, const u32* in, long long n,
                          cudaStream_t s) {
  int threads = 128;
  long long T = (n + lanes - 1) / lanes;
  long long blocks = (T + threads - 1) / threads;
  switch (lanes) {
    case 4: point_to_affine_kernel<E, 4><<<blocks, threads, 0, s>>>(ox, oy, in, n); break;
    case 8: point_to_affine_kernel<E, 8><<<blocks, threads, 0, s>>>(ox, oy, in, n); break;
    case 16: point_to_affine_kernel<E, 16><<<blocks, threads, 0, s>>>(ox, oy, in, n); break;
    default: point_to_affine_kernel<E, 32><<<blocks, threads, 0, s>>>(ox, oy, in, n); break;
  }
}

// L for n lanes: the largest of 32, 16, 8, 4 that still gives 64 threads to
// each of an H100's 132 SMs, else 4. A thread's chain (364 products of its
// inversion, 3 (L - 1) around it) is latency-bound at one or two warps a
// scheduler, so more lanes a thread only pay while the grid fills the card.
static int affine_lanes(long long n) {
  for (int lanes = 32; lanes > 4; lanes /= 2)
    if ((n + lanes - 1) / lanes >= 64LL * 132) return lanes;
  return 4;
}

// ox, oy: (C, 8, n); in: (3, C, 8, n); lanes: L (4, 8, 16 or 32)
extern "C" int snark_point_to_affine_lanes(int g2, int lanes, void* ox, void* oy, const void* in,
                                           long long n, void* stream) {
  if (n == 0) return 0;
  if (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    affine_launch<E2>(lanes, (u32*)ox, (u32*)oy, (const u32*)in, n, s);
  else
    affine_launch<E1>(lanes, (u32*)ox, (u32*)oy, (const u32*)in, n, s);
  return (int)cudaGetLastError();
}

// ox, oy: (C, 8, n); in: (3, C, 8, n)
extern "C" int snark_point_to_affine(int g2, void* ox, void* oy, const void* in, long long n,
                                     void* stream) {
  return snark_point_to_affine_lanes(g2, affine_lanes(n), ox, oy, in, n, stream);
}
