// K12: elementwise vector ops over the fields of the other curves
// (field_n.cuh): the Montgomery product, sum, difference, negation and b - a,
// over (nb, N, n) limb-major int32 with b broadcast as in K1 (field_vec.cu):
// b is (nbb, N, m), read at block bb % nbb and lane i % m.
//
// Replaces icicle_snark_tpu/fields/limbs.py mont_mul (:375), add_mod (:269),
// sub_mod (:293) and neg_mod (:336) at the FieldSpec widths of
// icicle_snark_tpu/curves/device.py (16, 24 and 48 16-bit limbs), and the
// field ops of its LimbFieldOps (:41, mul_many :62) and LimbFq2Ops (:110)
// on the card.
//
// Bound: the product by operations (N (4N + 1) 32-bit multiplies: N rounds
// of 2N for a * b_i, 1 for m and 2N for m * p), add / sub / neg by bytes
// (3 N words a lane). One thread per lane with coalesced limb loads.
#include "field_n.cuh"

template <class F>
__global__ void field_vec_n_kernel(int op, u32* __restrict__ out, const u32* __restrict__ a,
                                   const u32* __restrict__ b, long long nb, long long n,
                                   long long nbb, long long m) {
  constexpr int N = F::N;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * n) return;
  long long bb = t / n, i = t - bb * n;
  u32 x[N], y[N], r[N];
  nload<F>(x, a + bb * N * n, n, i);
  if (op != 3) nload<F>(y, b + (bb % nbb) * N * m, m, i % m);
  switch (op) {
    case 0: nmul<F>(r, x, y); break;
    case 1: nadd<F>(r, x, y); break;
    case 2: nsub<F>(r, x, y); break;
    case 4: nsub<F>(r, y, x); break;
    default: nneg<F>(r, x); break;
  }
  nstore<F>(out + bb * N * n, n, i, r);
}

template <class F>
static void launch(int op, void* out, const void* a, const void* b, long long nb, long long n,
                   long long nbb, long long m, cudaStream_t s) {
  int threads = 256;
  long long blocks = (nb * n + threads - 1) / threads;
  field_vec_n_kernel<F><<<blocks, threads, 0, s>>>(op, (u32*)out, (const u32*)a, (const u32*)b,
                                                   nb, n, nbb, m);
}

extern "C" int snark_field_vec_n(int op, int field, void* out, const void* a, const void* b,
                                 long long nb, long long n, long long nbb, long long m,
                                 void* stream) {
  if (nb * n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: launch<Bls377Fr>(op, out, a, b, nb, n, nbb, m, s); break;
    case 1: launch<Bls377Fq>(op, out, a, b, nb, n, nbb, m, s); break;
    case 2: launch<Bls381Fr>(op, out, a, b, nb, n, nbb, m, s); break;
    case 3: launch<Bls381Fq>(op, out, a, b, nb, n, nbb, m, s); break;
    case 4: launch<Bw6Fq>(op, out, a, b, nb, n, nbb, m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
