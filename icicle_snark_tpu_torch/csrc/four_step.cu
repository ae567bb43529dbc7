// K15: the four-step NTT's twiddle pass over one shard of a device mesh.
//
// Replaces icicle_snark_tpu/parallel/ntt_dist.py:70-75 (step 2 of
// ntt_four_step_partial: the gather tw_full[:, k1 * i2 % n] and its
// mont_mul) with the layout changes around it (:64-68, :77-84), which XLA
// lowered for the TPU.
//
// x is one shard's column-NTT output, (B, n2_loc, 8, n1): row (b, i2_loc)
// holds the column over k1, limb-major. Each element is multiplied by
// w^(k1 * i2), i2 = shard * n2_loc + i2_loc the global column (w the
// transform's root, or its inverse), and written to out as (d, B, n1 / d,
// 8, n2_loc): one contiguous block per destination shard (k1 / (n1 / d)),
// each [b][k1_loc][word][i2_loc], the layout the step-3 exchange sends and
// the row NTTs read once the blocks are concatenated on i2. k1 * i2 < n
// always, so no reduction mod n is needed. w^e is thi[e >> s] * tlo[e &
// (2^s - 1)], from two power tables of 2^s and n / 2^s entries (a few tens
// of KB, held in L1 and L2) instead of the JAX package's gather from the
// full n-entry table, whose neighbouring lanes read i2 apart. The twiddle
// does not depend on b: each thread builds the twiddle of its one (i2_loc,
// k1) once, in registers, and applies it to every batch row. A block is a
// tile of 32 k1 by 8 i2_loc that passes through shared memory, so that the
// reads run along k1 (128 bytes a word) and the writes along i2_loc (32
// bytes, one sector, a word). A taller tile, four twiddles a thread, keeps
// 32 more registers live and ran slower than one block a batch row: the
// registers, not the products, set the pace.
//
// Bound: (1 + 1 / B) Montgomery products per element (264 32-bit
// multiplies each) against 64 bytes moved; at B = 3 and Fr on an H100 the
// two limits are within 10% of each other, operations the larger.
#include "field.cuh"

#define FS_K1 32
#define FS_I2 8

__global__ void four_step_twiddle_kernel(u32* __restrict__ out, const u32* __restrict__ x,
                                         const u32* __restrict__ tlo,
                                         const u32* __restrict__ thi, long long batch,
                                         long long n1, long long n2_loc, long long d,
                                         long long shard, int s_log) {
  __shared__ u32 tile[SNARK_NLIMB][FS_I2][FS_K1 + 1];
  long long k1_0 = (long long)blockIdx.x * FS_K1;
  long long i2_0 = (long long)blockIdx.y * FS_I2;
  int tx = threadIdx.x, ty = threadIdx.y;
  long long n_lo = 1ll << s_log, n_hi = (n1 * n2_loc * d) >> s_log;
  long long n1_loc = n1 / d;
  // this thread's read: (i2_0 + ty, k1_0 + tx); its write: (k1_0 + wk, i2_0 + wi)
  long long i2l = i2_0 + ty, k1 = k1_0 + tx;
  bool in = i2l < n2_loc && k1 < n1;
  int t = ty * FS_K1 + tx, wi = t % FS_I2, wk = t / FS_I2;
  long long k1w = k1_0 + wk, i2w = i2_0 + wi;
  bool in_w = i2w < n2_loc && k1w < n1;
  long long dst = k1w / n1_loc, k1l = k1w - dst * n1_loc;
  u32 f[8];
  if (in) {
    u32 lo[8], hi[8];
    long long e = k1 * (shard * n2_loc + i2l);
    fload(lo, tlo, n_lo, e & (n_lo - 1));
    fload(hi, thi, n_hi, e >> s_log);
    fmul<Fr>(f, hi, lo);
  }
  for (long long b = 0; b < batch; b++) {
    if (in) {
      u32 v[8], r[8];
      fload(v, x + (b * n2_loc + i2l) * 8 * n1, n1, k1);
      fmul<Fr>(r, v, f);
#pragma unroll
      for (int w = 0; w < 8; w++) tile[w][ty][tx] = r[w];
    }
    __syncthreads();
    if (in_w) {
      u32* o = out + ((dst * batch + b) * n1_loc + k1l) * 8 * n2_loc;
#pragma unroll
      for (int w = 0; w < 8; w++) o[w * n2_loc + i2w] = tile[w][wi][wk];
    }
    __syncthreads();
  }
}

// out, x, tlo, thi and (batch, n1, n2_loc, d, shard, s_log) as above.
extern "C" int snark_four_step(void* out, const void* x, const void* tlo, const void* thi,
                               long long batch, long long n1, long long n2_loc, long long d,
                               long long shard, int s_log, void* stream) {
  if (batch == 0 || n1 == 0 || n2_loc == 0) return 0;
  dim3 grid((unsigned)((n1 + FS_K1 - 1) / FS_K1), (unsigned)((n2_loc + FS_I2 - 1) / FS_I2));
  dim3 block(FS_K1, FS_I2);
  four_step_twiddle_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (u32*)out, (const u32*)x, (const u32*)tlo, (const u32*)thi, batch, n1, n2_loc, d, shard,
      s_log);
  return (int)cudaGetLastError();
}
