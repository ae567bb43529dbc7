// K14: one radix-2 butterfly stage of a batched NTT over the scalar fields of
// the other curves, in place: bls12-377 Fr and bls12-381 Fr (8 words) and
// bw6-761 Fr (bls12-377's Fq, 12 words), field_n.cuh. K3's design
// (ntt.cu) over F: DIF (u + v, (u - v) w) for the inverse, each output times
// `scale` in the last inverse stage (1/n), DIT (u + v w, u - v w) for the
// forward transform; one thread per butterfly, log2(n) launches a transform.
//
// Replaces icicle_snark_tpu/ops/ntt.py ntt_dit (:158) and intt_dif (:180)
// over a non-BN254 FieldSpec (NTTDomain(log_n, spec, root_tower), :104), as
// tests/test_curves.py and ntt(spec=...) (:228) drive them.
//
// x is (B, N, n) limb-major int32; tw the (N, n) STAGE-MAJOR table of the
// transform's root (ops/ntt.py stage_major): the stage of span m reads its
// twiddle w_m^j at lane m/2 - 1 + j, so a warp's twiddle loads are
// consecutive. Bound: operations, one Montgomery product per butterfly (two
// more in the scaled stage); each stage also streams the batch once.
#include "field_n.cuh"

template <class F>
__global__ void ntt_stage_n_kernel(u32* __restrict__ x, const u32* __restrict__ tw,
                                   const u32* __restrict__ scale, long long batch, long long n,
                                   long long m, int inverse) {
  constexpr int N = F::N;
  long long half_n = n >> 1;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * half_n) return;
  long long bb = t / half_n, r = t - bb * half_n;
  long long h = m >> 1;
  long long blk = r / h, j = r - blk * h;
  long long i0 = blk * m + j, i1 = i0 + h;
  u32* xb = x + bb * N * n;
  u32 u[N], v[N], w[N], a[N], b[N];
  nload<F>(u, xb, n, i0);
  nload<F>(v, xb, n, i1);
  nload<F>(w, tw, n, h - 1 + j);
  if (inverse) {
    u32 d[N];
    nadd<F>(a, u, v);
    nsub<F>(d, u, v);
    nmul<F>(b, d, w);
    if (scale) {
      u32 s[N];
      nload<F>(s, scale, 1, 0);
      nmul<F>(a, a, s);
      nmul<F>(b, b, s);
    }
  } else {
    u32 vw[N];
    nmul<F>(vw, v, w);
    nadd<F>(a, u, vw);
    nsub<F>(b, u, vw);
  }
  nstore<F>(xb, n, i0, a);
  nstore<F>(xb, n, i1, b);
}

template <class F>
static void launch(u32* x, const u32* tw, const u32* scale, long long batch, long long n,
                   long long m, int inverse, cudaStream_t s) {
  int threads = 256;
  long long blocks = (batch * (n >> 1) + threads - 1) / threads;
  ntt_stage_n_kernel<F><<<blocks, threads, 0, s>>>(x, tw, scale, batch, n, m, inverse);
}

// field: the K12 selector (curves/device.py KERNEL_FIELDS), 0, 1 or 2 here
extern "C" int snark_ntt_stage_n(int field, void* x, const void* tw, const void* scale,
                                 long long batch, long long n, long long m, int inverse,
                                 void* stream) {
  if (batch * (n >> 1) == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  u32* xp = (u32*)x;
  const u32 *twp = (const u32*)tw, *sp = (const u32*)scale;
  switch (field) {
    case 0: launch<Bls377Fr>(xp, twp, sp, batch, n, m, inverse, s); break;
    case 1: launch<Bls377Fq>(xp, twp, sp, batch, n, m, inverse, s); break;
    case 2: launch<Bls381Fr>(xp, twp, sp, batch, n, m, inverse, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
