// K11: fixed-base scalar multiplication P_i = k_i * G for G1 and G2, the
// device trusted setup's point generation.
//
// Replaces icicle_snark_tpu/setup/fast_setup.py _fixed_base_msm (:81): there a
// lax.scan of 32 steps, each a gather from the window table and a full-width
// jcurve.pmadd graph over all lanes; the port's plain version
// (setup/fast_setup.py fixed_base_msm_plain) makes every field operation of
// those 32 mixed adds a K1 launch over a chunk of lanes.
//
// One thread owns one lane and keeps its projective sum in registers for all
// 32 windows: the window digit (8 bits of the scalar, low window first,
// shifted out of the 8 scalar words held in registers) picks the table record
// T[w][d] = d * 2^(8w) * G, affine and lane-major (ops/msm.py point_records:
// 64 bytes G1, 128 bytes G2), read as 16-byte vectors through the read-only
// path; the whole table (32 x 256 records, 512 KB for G1, 1 MB for G2) sits in
// the 50 MB L2. A zero digit selects the identity (0, 0), which the mixed add
// passes through, so it is skipped. The mixed add is RCB15 algorithm 8, the
// formula of jcurve.pmadd, so every lane's projective point equals the plain
// version's word for word; K7 point_to_affine then makes it affine.
//
// G1 (fixed_base_g1_kernel, fq_lazy.cuh): the window loop keeps every
// coordinate lazy in [0, 2q) (no final subtraction after a product, 9x as one
// multiply by 9 and one reduction) and makes it canonical at the store. The
// block's 256 threads walk the windows in step: window w + 1's 256 records
// (16 KB) are staged into shared memory by cp.async while window w's mixed
// adds run, so no add waits on a dependent L2 round trip. Blocks of 256
// threads at two an SM (128 registers) measured fastest on an H100 against
// 128-thread blocks, 512-thread blocks and the record loaded one window ahead
// into registers (PERF.md, Findings). G2 (fixed_base_kernel<E2>):
// curve.cuh's canonical p_madd, the record loaded when its window comes.
//
// Bound: operations. Per lane at most 32 mixed adds of 11 (G1) or 39 (G2) Fq
// products against 32 bytes of scalar in and 96 (G1) or 192 (G2) bytes out.
// The loop is not unrolled: one inlined G2 mixed add already costs ptxas most
// of a minute, and the G2 kernel, like K4's, is expected at the 255-register
// ceiling with spills (the build's -Xptxas -v line says).
#include "fq_lazy.cuh"

template <class E>
__global__ void fixed_base_kernel(u32* __restrict__ out, const u32* __restrict__ scalars,
                                  const u32* __restrict__ table, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 s[8];
  fload(s, scalars, n, i);
  Pt<E> acc = p_identity<E>();
#pragma unroll 1
  for (int w = 0; w < 32; w++) {
    u32 d = s[0] & 0xffu;
#pragma unroll
    for (int k = 0; k < 7; k++) s[k] = (s[k] >> 8) | (s[k + 1] << 24);
    s[7] >>= 8;
    if (d == 0) continue;
    E x, y;
    rec_load(x, y, table, (long long)w * 256 + d);
    acc = p_madd(acc, x, y);
  }
  p_store(out, n, i, acc);
}

__global__ void __launch_bounds__(256, 2)
    fixed_base_g1_kernel(u32* __restrict__ out, const u32* __restrict__ scalars,
                         const u32* __restrict__ table, long long n) {
  __shared__ __align__(16) u32 buf[2 * 4096];
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  fixed_base_g1_lane(out, scalars, table, n, i, threadIdx.x, blockDim.x, buf);
}

// out: (3, C, 8, n); scalars: (8, n); table: (32 * 256, 16) G1 or (32 * 256, 32) G2
extern "C" int snark_fixed_base_msm(int g2, void* out, const void* scalars, const void* table,
                                    long long n, void* stream) {
  if (n == 0) return 0;
  int threads = g2 ? 128 : 256;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2)
    fixed_base_kernel<E2><<<blocks, threads, 0, s>>>((u32*)out, (const u32*)scalars,
                                                     (const u32*)table, n);
  else
    fixed_base_g1_kernel<<<blocks, threads, 0, s>>>((u32*)out, (const u32*)scalars,
                                                    (const u32*)table, n);
  return (int)cudaGetLastError();
}
