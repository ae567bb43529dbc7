// K18: the witness's words turned on the card, (n, 8) -> (8, n).
//
// Replaces icicle_snark_tpu/fields/limbs.py u32x8_to_limbs_device (:153),
// which the JAX pipeline runs on the uploaded words
// (icicle_snark_tpu/prover/pipeline.py:371-373). The prove uploads the
// .wtns section's words as the file holds them (prover/pipeline.py
// upload_words) and this kernel turns them into the limb-major layout that
// K2 and K4 take; the host no longer makes the strided copy
// (fields/limbs.py words_to_host_limbs, now the plain version).
//
// Bound: bytes, 64 a row (32 read, 32 written): 102 MB at complex-1600k's
// 1 600 003 rows, 0.031 ms at 3.35 TB/s. One thread a row: two 16-byte
// loads (the second lands in the 32-byte sector the first brought into L1)
// and eight 4-byte stores, each a coalesced 128-byte stream of a warp.
#include <cuda_runtime.h>

typedef unsigned int u32;

__global__ void __launch_bounds__(256)
    witness_limbs_kernel(u32* __restrict__ out, const uint4* __restrict__ in, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 lo = __ldg(in + 2 * i), hi = __ldg(in + 2 * i + 1);
  out[i] = lo.x;
  out[n + i] = lo.y;
  out[2 * n + i] = lo.z;
  out[3 * n + i] = lo.w;
  out[4 * n + i] = hi.x;
  out[5 * n + i] = hi.y;
  out[6 * n + i] = hi.z;
  out[7 * n + i] = hi.w;
}

// out (8, n) limbs, in (n, 8) words (int32 read as uint32), `in` 16-byte aligned.
extern "C" int snark_witness_limbs(void* out, const void* in, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  witness_limbs_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>((u32*)out, (const uint4*)in, n);
  return (int)cudaGetLastError();
}
