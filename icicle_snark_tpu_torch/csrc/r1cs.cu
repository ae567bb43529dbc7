// K2: R1CS evaluation, one thread per output slot over its CSR range:
//   out[s] = (sum_j coef[j] * w[idx[j]] * R^-1) * R^-1  mod r,   j in [off[s], off[s+1])
// i.e. the Montgomery product of each term, summed mod r term by term, then
// one REDC (a product with standard 1).
//
// Replaces icicle_snark_tpu/prover/pipeline.py _segment_reduce (:55) with the
// gather and product at :96-106, and fields/limbs.py redc_wide (:448). The TPU
// had no scatter atomics, so it summed 16-bit limb columns with segment_sum
// and needed a two-level plan past 2^15 terms per slot; reducing mod r after
// every term has no such bound, so the port's plan is a single CSR level.
//
// Bound: the larger of the bytes (coefs, indices, offsets, witness and
// output, each once) and the products (one Montgomery product per term, one
// REDC by 1 per nonempty slot); at complex-100k the two are close. The
// witness gather is random but the witness (3.2 MB at 100k) sits in L2.
#include "field.cuh"

__global__ void r1cs_reduce_kernel(u32* __restrict__ out, const u32* __restrict__ coefs,
                                   const int* __restrict__ widx, const int* __restrict__ offsets,
                                   const u32* __restrict__ witness, long long nnz,
                                   long long n_slots, long long n_vars) {
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  u32 acc[8], c[8], w[8], t[8];
#pragma unroll
  for (int k = 0; k < 8; k++) acc[k] = 0;
  int lo = offsets[s], hi = offsets[s + 1];
  for (int j = lo; j < hi; j++) {
    fload(c, coefs, nnz, j);
    fload(w, witness, n_vars, widx[j]);
    fmul<Fr>(t, c, w);
    fadd<Fr>(acc, acc, t);
  }
  u32 one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  fmul<Fr>(t, acc, one);
  fstore(out, n_slots, s, t);
}

extern "C" int snark_r1cs_reduce(void* out, const void* coefs, const void* widx,
                                 const void* offsets, const void* witness, long long nnz,
                                 long long n_slots, long long n_vars, void* stream) {
  if (n_slots == 0) return 0;
  int threads = 128;
  long long blocks = (n_slots + threads - 1) / threads;
  r1cs_reduce_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (u32*)out, (const u32*)coefs, (const int*)widx, (const int*)offsets,
      (const u32*)witness, nnz, n_slots, n_vars);
  return (int)cudaGetLastError();
}
