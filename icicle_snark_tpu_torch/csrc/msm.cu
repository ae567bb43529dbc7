// K4 accumulate: Pippenger bucket sums for the grouped G1 MSM (Fq
// coordinates) and the G2 MSM (Fq2 coordinates). The window reduction, K4's
// other half, is csrc/msm_reduce.cu.
//
// Replaces icicle_snark_tpu/ops/msm.py _window_bucket_prefixes (:609),
// PrefixTree (:257), _chunked_inclusive_scan (:198) and the pipelines around
// them (:727, :790, :935, :943). The TPU had no scatter atomics and no
// per-lane control flow, so it summed buckets as prefix-sum differences of
// the sorted points. On Hopper a thread walks a run of sorted lanes.
//
// The lanes of each window arrive sorted by key = group * (H + 1) + |digit|
// (torch.sort in ops/msm.py), so bucket (window, group, b) is a run of
// consecutive sorted positions. ops/msm.py `bucket_fold_plan` cuts every run
// into pieces of at most L = BUCKET_PIECE positions (torch cumsum and
// repeat_interleave) and hands this kernel one table per level:
//   level 0:  one thread per piece mixed-adds the piece's affine points (y
//             negated for a negative digit), starting from the first point;
//   level >0: one thread per piece of the previous level's partial sums adds
//             them in order with complete projective adds,
// until every bucket has at most L inputs; that last level has one item per
// bucket (an empty bucket gives the identity) and writes the bucket sums,
// (3, coords..., W*G*H), bucket b at b - 1, which msm_reduce.cu reads.
//
// Longest serial chain per thread: L - 1 additions per level, over
// ceil(log_L(R)) levels for the longest run R (1 level when R <= L), so at
// most (L - 1) * ceil(log_L(R)) whatever the digits: a bit-valued witness,
// which puts half of all lanes into bucket 1 of window 0, only adds levels.
// The order of additions is fixed by the tables (no atomics on points), so
// every run gives the same words and the plain version mirrors them.
//
// Bound: operations, one mixed add per lane with a nonzero digit (11 Fq
// products for G1, 39 for G2; chip_smoke.py counts them from the digits).
// What the design does about the old kernel's faults:
//   * thread per bucket, time set by the longest run: pieces of at most L;
//   * 16 or 32 scattered 32-byte sectors per limb-major point: points come
//     as lane-major records (64 bytes G1, 128 G2), read as 16-byte vectors;
//   * a __noinline__ mixed add whose 24/48-word operands went through the
//     call stack: p_madd and p_add_inl are force-inlined into the loop.
#include "curve.cuh"

#define ACC_THREADS 128

template <class E>
__device__ __forceinline__ void load_signed(E& x, E& y, const u32* __restrict__ rec,
                                            const int* __restrict__ order,
                                            const unsigned char* __restrict__ negs,
                                            long long pos) {
  rec_load(x, y, rec, order[pos]);
  if (negs[pos]) y = e_neg(y);
}

// AFF: src is the (total, words) record array, start[i] a flattened
// (window, sorted position) index into order/negs. Otherwise src is the
// previous level's (3, coords..., n_src) partial sums, start[i] an index into
// them. Item i adds len[i] inputs from start[i] on and writes out[i].
template <class E, bool AFF>
__global__ void __launch_bounds__(ACC_THREADS)
    msm_accumulate_kernel(u32* __restrict__ out, const u32* __restrict__ src, long long n_src,
                          const int* __restrict__ order, const unsigned char* __restrict__ negs,
                          const long long* __restrict__ start, const int* __restrict__ len,
                          long long n_items) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  long long st = start[i];
  int ln = len[i];
  Pt<E> acc = p_identity<E>();
  if (ln > 0) {
    if constexpr (AFF) {
      E x, y;
      load_signed(x, y, src, order, negs, st);
      if (!(e_is_zero(x) && e_is_zero(y))) {
        acc.x = x;
        acc.y = y;
        e_set_one(acc.z);
      }
      for (int r = 1; r < ln; r++) {
        load_signed(x, y, src, order, negs, st + r);
        acc = p_madd(acc, x, y);
      }
    } else {
      acc = p_load<E>(src, n_src, st);
      for (int r = 1; r < ln; r++) acc = p_add_inl(acc, p_load<E>(src, n_src, st + r));
    }
  }
  p_store(out, n_items, i, acc);
}

template <class E, bool AFF>
static void launch_accumulate(void* out, const void* src, long long n_src, const void* order,
                              const void* negs, const void* start, const void* len,
                              long long n_items, cudaStream_t s) {
  long long blocks = (n_items + ACC_THREADS - 1) / ACC_THREADS;
  msm_accumulate_kernel<E, AFF><<<blocks, ACC_THREADS, 0, s>>>(
      (u32*)out, (const u32*)src, n_src, (const int*)order, (const unsigned char*)negs,
      (const long long*)start, (const int*)len, n_items);
}

extern "C" int snark_msm_accumulate(int g2, int affine, void* out, const void* src,
                                    long long n_src, const void* order, const void* negs,
                                    const void* start, const void* len, long long n_items,
                                    void* stream) {
  if (n_items == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2 && affine)
    launch_accumulate<E2, true>(out, src, n_src, order, negs, start, len, n_items, s);
  else if (g2)
    launch_accumulate<E2, false>(out, src, n_src, order, negs, start, len, n_items, s);
  else if (affine)
    launch_accumulate<E1, true>(out, src, n_src, order, negs, start, len, n_items, s);
  else
    launch_accumulate<E1, false>(out, src, n_src, order, negs, start, len, n_items, s);
  return (int)cudaGetLastError();
}
