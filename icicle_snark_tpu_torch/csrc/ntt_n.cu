// K14's one-stage kernel, redesigned: the batched NTT over the other
// curves' scalar fields below NTT_BLOCK_MIN_LOG (and on the forced route
// that checks K14's passes), as passes of r radix-2 stages in registers
// (ntt_radix.cuh, where the design is), over field_n.cuh's F: bls12-377 Fr
// and bls12-381 Fr (8 words, r <= 4) and bw6-761 Fr (bls12-377's Fq, 12
// words, r <= 3). Only the C entries live here.
//
// Replaces icicle_snark_tpu/ops/ntt.py ntt_dit (:158) and intt_dif (:180)
// over a non-BN254 FieldSpec (NTTDomain(log_n, spec, root_tower), :104), as
// tests/test_curves.py and ntt(spec=...) (:228) drive them.
#include "ntt_radix.cuh"

// field: the K12 selector (curves/device.py KERNEL_FIELDS), 0, 1 or 2 here.
// One pass (low, r) over x (batch, N, n) in place with the (N, n)
// stage-major table stw; scale NULL or one (N, 1) value times every output
// of an inverse pass.
extern "C" int snark_ntt_radix_n(int field, void* x, const void* stw, const void* scale,
                                 long long batch, long long n, int low, int r, int inverse,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return ntt_radix_dispatch<RadixN<Bls377Fr>>(x, stw, scale, batch, n, low, r,
                                                        inverse, s);
    case 1: return ntt_radix_dispatch<RadixN<Bls377Fq>>(x, stw, scale, batch, n, low, r,
                                                        inverse, s);
    case 2: return ntt_radix_dispatch<RadixN<Bls381Fr>>(x, stw, scale, batch, n, low, r,
                                                        inverse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One stage of span m in place, the stage-major table's stage at lanes
// m/2 - 1 .. m - 2: the pass (log2(m) - 1, 1), the template's R = 1 kernel;
// scale multiplies both outputs of an inverse stage.
extern "C" int snark_ntt_stage_n(int field, void* x, const void* stw, const void* scale,
                                 long long batch, long long n, long long m, int inverse,
                                 void* stream) {
  const int low = radix_stage_low(n, m);
  if (low < 0) return (int)cudaErrorInvalidValue;
  return snark_ntt_radix_n(field, x, stw, scale, batch, n, low, 1, inverse, stream);
}
