// K3: one radix-2 butterfly stage of the batched Fr NTT, in place.
//
// Replaces icicle_snark_tpu/ops/ntt.py intt_dif (:180) and ntt_dit (:158),
// the per-stage reshape + mont_mul/add_mod/sub_mod graphs XLA lowered for the
// TPU. The port keeps their reorder-free pairing: the inverse transform is
// Gentleman-Sande (natural in, bit-reversed out, scaled by 1/n in its last
// stage) and the forward one Cooley-Tukey (bit-reversed in, natural out).
//
// x is (B, 8, n) limb-major int32; tw the (8, n) power table of the
// transform's root, so the stage-m twiddle w_m^j is tw[j * n / m]. One thread
// per butterfly; the wrapper launches log2(n) stages per transform.
// Bound: operations (one Montgomery product per butterfly, two in the scaled
// last inverse stage); each stage also streams the whole batch once.
#include "field.cuh"

__global__ void ntt_stage_kernel(u32* __restrict__ x, const u32* __restrict__ tw,
                                 const u32* __restrict__ scale, long long batch, long long n,
                                 long long m, int inverse) {
  long long half_n = n >> 1;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * half_n) return;
  long long bb = t / half_n, r = t - bb * half_n;
  long long h = m >> 1;
  long long blk = r / h, j = r - blk * h;
  long long i0 = blk * m + j, i1 = i0 + h;
  u32* xb = x + bb * 8 * n;
  u32 u[8], v[8], w[8], a[8], b[8];
  fload(u, xb, n, i0);
  fload(v, xb, n, i1);
  fload(w, tw, n, j * (n / m));
  if (inverse) {
    u32 d[8];
    fadd<Fr>(a, u, v);
    fsub<Fr>(d, u, v);
    fmul<Fr>(b, d, w);
    if (scale) {
      u32 s[8];
      fload(s, scale, 1, 0);
      fmul<Fr>(a, a, s);
      fmul<Fr>(b, b, s);
    }
  } else {
    u32 vw[8];
    fmul<Fr>(vw, v, w);
    fadd<Fr>(a, u, vw);
    fsub<Fr>(b, u, vw);
  }
  fstore(xb, n, i0, a);
  fstore(xb, n, i1, b);
}

extern "C" int snark_ntt_stage(void* x, const void* tw, const void* scale, long long batch,
                               long long n, long long m, int inverse, void* stream) {
  long long lanes = batch * (n >> 1);
  if (lanes == 0) return 0;
  int threads = 256;
  long long blocks = (lanes + threads - 1) / threads;
  ntt_stage_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (u32*)x, (const u32*)tw, (const u32*)scale, batch, n, m, inverse);
  return (int)cudaGetLastError();
}
