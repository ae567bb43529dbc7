// K1: elementwise Fr / Fq vector ops (Montgomery product, add, sub, negate,
// and b - a, the scalar-minus-vector of ops/vec_ops.py scalar_sub).
//
// Replaces icicle_snark_tpu/fields/limbs.py mont_mul/_mont_mul_core (:375/:394),
// add_mod (:269), sub_mod (:293), neg_mod (:336) and to_mont (:610), which XLA
// lowered for the TPU VPU over 16 x 16-bit limbs, and the elementwise, scalar,
// mixed and batched ops of icicle_snark_tpu/ops/vec_ops.py (:26-66, :96-133).
//
// Layout: a is (nb, 8, n) limb-major int32 (a field vector is nb = 1, an Fq2
// vector nb = 2, a batch of polynomials nb = B). b broadcasts: it is
// (nbb, 8, m) with nb % nbb == 0 and n % m == 0, read at block bb % nbb and
// lane i % m (m = 1 is a constant, nbb = 1 a table shared by the batch).
//
// Bound: the product is bound by operations (264 32-bit multiplies per
// Montgomery product, 8 rounds of 33); add/sub/neg by bytes (96 B per lane).
// One thread per lane with coalesced limb loads; no shared memory needed.
#include "field.cuh"

template <class F>
__global__ void field_vec_kernel(int op, u32* __restrict__ out, const u32* __restrict__ a,
                                 const u32* __restrict__ b, long long nb, long long n,
                                 long long nbb, long long m) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * n) return;
  long long bb = t / n, i = t - bb * n;
  const u32* ab = a + bb * 8 * n;
  u32 x[8], y[8], r[8];
  fload(x, ab, n, i);
  if (op != 3) {
    const u32* bbase = b + (bb % nbb) * 8 * m;
    fload(y, bbase, m, i % m);
  }
  switch (op) {
    case 0: fmul<F>(r, x, y); break;
    case 1: fadd<F>(r, x, y); break;
    case 2: fsub<F>(r, x, y); break;
    case 4: fsub<F>(r, y, x); break;
    default: fneg<F>(r, x); break;
  }
  fstore(out + bb * 8 * n, n, i, r);
}

extern "C" int snark_field_vec(int op, int field, void* out, const void* a, const void* b,
                               long long nb, long long n, long long nbb, long long m,
                               void* stream) {
  long long lanes = nb * n;
  if (lanes == 0) return 0;
  int threads = 256;
  long long blocks = (lanes + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    field_vec_kernel<Fr><<<blocks, threads, 0, s>>>(op, (u32*)out, (const u32*)a,
                                                    (const u32*)b, nb, n, nbb, m);
  else
    field_vec_kernel<Fq><<<blocks, threads, 0, s>>>(op, (u32*)out, (const u32*)a,
                                                    (const u32*)b, nb, n, nbb, m);
  return (int)cudaGetLastError();
}
