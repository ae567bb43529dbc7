// K2: R1CS evaluation, one work item per constraint row, writing the
// (3, 8, n) batch that K5 transforms:
//   A[c] = REDC(sum_j coef[j] * w[idx[j]] * R^-1),  j in the CSR range of slot c
//   B[c] = the same over slot n + c
//   C[c] = A[c] * B[c] * R^-1                        (Montgomery product)
// i.e. the Montgomery product of each term, summed mod r, then one REDC (a
// product with standard 1); C carries R^-1 as the JAX package's does.
//
// Replaces icicle_snark_tpu/prover/pipeline.py _segment_reduce (:55) with
// the gather and product at :96-106 and fields/limbs.py redc_wide (:448),
// and the A * B product of pipeline.py :226 that followed it. The TPU had no
// scatter atomics: it summed 16-bit limb columns with segment_sum and needed
// a two-level plan past 2^15 terms per slot. Here a slot's sum is reduced mod
// r term by term (field_ptx.cuh, lazy in [0, 2r)), so no fan-in overflows.
//
// Bounded work per thread: a slot of at most `piece` terms is summed by its
// row's thread. A longer slot (a circom circuit's linear-combination or
// public-input rows) is summed beforehand by FOLD launches: level 0 sums
// pieces of at most `piece` consecutive terms, each later level pieces of at
// most `piece` partial sums of one slot, until one partial is left per long
// slot (ops in prover/pipeline.py r1cs_fold_plan; the complex circuit's rows
// never need one). The row's thread finds its slot's partial by a binary
// search in the sorted list of long slots.
//
// Bound: the larger of the bytes (coefs, indices, offsets, witness, each
// once, and the (3, 8, n) batch written) and the products (one per term,
// one REDC per nonempty slot, one for C per row). The witness gather is
// random: at complex-1600k the witness (51 MB, limb-major) is just over the
// card's 50 MB L2, and each term reads 8 words from 8 limb rows.
#include "field_ptx.cuh"

// acc = sum of the terms of [lo, hi): Montgomery products of the terms, or
// partial sums of the previous level (prev, canonical)
__device__ __forceinline__ void sum_range(u32 acc[8], int lo, int hi, const u32* __restrict__ coefs,
                                          const int* __restrict__ widx,
                                          const u32* __restrict__ witness,
                                          const u32* __restrict__ prev, long long nnz,
                                          long long n_vars, long long n_prev) {
#pragma unroll
  for (int l = 0; l < 8; l++) acc[l] = 0;
  for (int j = lo; j < hi; j++) {
    u32 t[8];
    if (prev) {
      fload(t, prev, n_prev, j);
    } else {
      u32 c[8], w[8];
      fload(c, coefs, nnz, j);
      fload(w, witness, n_vars, widx[j]);
      fr_mul(t, c, w);
    }
    fr_add2(acc, acc, t);
  }
}

// One fold level: out[p] = sum of inputs [starts[p], ends[p]), canonical.
__global__ void r1cs_fold_kernel(u32* __restrict__ out, const int* __restrict__ starts,
                                 const int* __restrict__ ends, const u32* __restrict__ coefs,
                                 const int* __restrict__ widx, const u32* __restrict__ witness,
                                 const u32* __restrict__ prev, long long nnz, long long n_vars,
                                 long long n_prev, long long n_items) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_items) return;
  u32 acc[8], r[8];
  sum_range(acc, starts[p], ends[p], coefs, widx, witness, prev, nnz, n_vars, n_prev);
  fr_canon(r, acc);
  fstore(out, n_items, p, r);
}

__global__ void r1cs_rows_kernel(u32* __restrict__ batch, const u32* __restrict__ coefs,
                                 const int* __restrict__ widx, const int* __restrict__ offsets,
                                 const u32* __restrict__ witness,
                                 const int* __restrict__ long_slots,
                                 const u32* __restrict__ folded, long long nnz, long long n,
                                 long long n_vars, long long n_long, int piece) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const u32 one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  u32 ab[2][8];
#pragma unroll
  for (int m = 0; m < 2; m++) {
    const long long s = m * n + c;
    const int lo = offsets[s], hi = offsets[s + 1];
    u32 acc[8], t[8];
    if (hi - lo <= piece) {
      sum_range(acc, lo, hi, coefs, widx, witness, nullptr, nnz, n_vars, 0);
    } else {
      long long a = 0, b = n_long - 1;  // long_slots is sorted and holds s
      while (a < b) {
        long long mid = (a + b) >> 1;
        if (long_slots[mid] < s) a = mid + 1; else b = mid;
      }
      fload(acc, folded, n_long, a);
    }
    fr_mul(t, acc, one);  // REDC: <= r
    fr_canon(ab[m], t);
  }
  u32 t[8], cc[8];
  fr_mul(t, ab[0], ab[1]);
  fr_canon(cc, t);
  fstore(batch, n, c, ab[0]);
  fstore(batch + 8 * n, n, c, ab[1]);
  fstore(batch + 16 * n, n, c, cc);
}

// mode 0: the rows into out = batch (3, 8, n); the long slots' sums are
// prev (8, n_items), slot by slot as long_slots (n_items,) lists them.
// mode 1: one fold level into out (8, n_items), from the terms (prev NULL)
// or from the previous level's partials prev (8, n_prev).
extern "C" int snark_r1cs_rows(int mode, void* out, const void* coefs, const void* widx,
                               const void* offsets, const void* witness, const void* starts,
                               const void* ends, const void* prev, const void* long_slots,
                               long long nnz, long long n, long long n_vars, long long n_prev,
                               long long n_items, int piece, void* stream) {
  const int threads = 128;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    if (n == 0) return 0;
    if (n_items > 0 && (!long_slots || !prev)) return (int)cudaErrorInvalidValue;
    r1cs_rows_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        (u32*)out, (const u32*)coefs, (const int*)widx, (const int*)offsets, (const u32*)witness,
        (const int*)long_slots, (const u32*)prev, nnz, n, n_vars, n_items, piece);
  } else {
    if (n_items == 0) return 0;
    r1cs_fold_kernel<<<(n_items + threads - 1) / threads, threads, 0, s>>>(
        (u32*)out, (const int*)starts, (const int*)ends, (const u32*)coefs, (const int*)widx,
        (const u32*)witness, (const u32*)prev, nnz, n_vars, n_prev, n_items);
  }
  return (int)cudaGetLastError();
}
