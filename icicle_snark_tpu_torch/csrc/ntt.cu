// K3: the batched BN254 Fr NTT below NTT_BLOCK_MIN_LOG, as passes of r
// radix-2 stages in registers (ntt_radix.cuh, where the design is), over
// field.cuh's Fr. Only the C entries live here.
//
// Replaces icicle_snark_tpu/ops/ntt.py intt_dif (:180) and ntt_dit (:158).
#include "ntt_radix.cuh"

// One pass: the stages of spans 2^(low+1) .. 2^(low+r) of every row of x
// (batch, 8, n) in place, 1 <= r <= 4, with the (8, n) stage-major table
// stw; scale NULL or one (8, 1) value times every output of an inverse pass.
extern "C" int snark_ntt_radix(void* x, const void* stw, const void* scale, long long batch,
                               long long n, int low, int r, int inverse, void* stream) {
  return ntt_radix_dispatch<RadixFr>(x, stw, scale, batch, n, low, r, inverse,
                                     (cudaStream_t)stream);
}

// One stage of span m, in place, over the natural (8, n) power table tw (the
// stage-m twiddle w_m^j at tw[j n / m]): the template's R = 1 instance; scale
// multiplies both outputs of an inverse stage.
extern "C" int snark_ntt_stage(void* x, const void* tw, const void* scale, long long batch,
                               long long n, long long m, int inverse, void* stream) {
  const int low = radix_stage_low(n, m);
  if (low < 0) return (int)cudaErrorInvalidValue;
  return ntt_radix_launch<RadixFr, 1, true>(x, tw, scale, batch, n, low, inverse,
                                            (cudaStream_t)stream);
}
