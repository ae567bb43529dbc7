// K19: the MSM's bucket sort (ops/msm.py sort_windows), in two launches.
//
// Replaces the sort of icicle_snark_tpu/ops/msm.py _window_bucket_prefixes
// (:653 lax.sort, :664 argsort), one per window, and the digits and keys
// around it (window_digits_signed :167, _merge_digit_windows :594).
//
// Every (window w, lane l) of an MSM pipeline is one pair of 32-bit words:
//   key   = w * KR + group(l) * (H + 1) + |digit|,  KR = (G + 1)(H + 1),
//   value = l | neg << 31  (the lane, its digit's sign in the top bit),
// where H = 2^(c-1) and group G is the sliced route's sentinel, which sorts
// past every bucket. Every key lies below W * KR, 22 bits at c = 16 with up
// to four groups, so one stable LSD radix sort of the flat pairs over those
// bits alone (3 passes of 8 bits) orders every window at once, each row in
// place: window w's keys lie in [w KR, (w + 1) KR) and it has `total` of
// them. torch.sort ran one sort a window over all 64 bits of int64 keys
// with int64 indices: 8 passes of 16-byte pairs against 3 of 8 bytes.
//
// msm_sort_keys_kernel: one thread a scalar lane reads its words once
// (coalesced, limb-major) and writes the pair of every window: the signed
// c-bit digits of window_digits_signed, read off a 64-bit bit buffer so
// that no word is indexed at run time, placed as merge_digit_windows puts
// them (merged window j = w mod wp, lane l * f + w / wp; the dead slots
// past the digit windows take digit 0). Bound: bytes, 4 a scalar word and
// the group base read, 8 a pair written.
//
// snark_msm_sort: cub's DeviceRadixSort::SortPairs on a double buffer of
// (key, value) words over key bits [0, end_bit), on the caller's stream,
// in temporary storage that the caller allocates (snark_msm_sort_bytes
// gives its size). Stable, and the values enter in lane order, so the
// order within a bucket is torch.sort(stable=True)'s. Bound: bytes, about
// 2 x 8 a pair for each onesweep pass plus the histogram pass's read.
// cub sits in the namespace msm_sort, so its kernels carry this kernel's
// name in a trace (msm_sort::cub::...DeviceRadixSortOnesweepKernel).
#define CUB_WRAPPED_NAMESPACE msm_sort
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

template <int WORDS>
__global__ void __launch_bounds__(256)
    msm_sort_keys_kernel(u32* __restrict__ keys, u32* __restrict__ vals,
                         const u32* __restrict__ scalars, const u32* __restrict__ base,
                         long long n, int c, int wp, int f, u32 kr_step) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = n * f;  // lanes of a merged window
  const u32 b = __ldg(base + i);
  const u32 mask = (1u << c) - 1, half = 1u << (c - 1);
  u64 acc = 0;
  int nbits = 0, w = 0;
  u32 carry = 0;
  auto put = [&](u32 a, bool neg) {
    const int j = w % wp, m = w / wp;
    const long long lane = i * f + m, pos = (long long)j * row + lane;
    keys[pos] = (u32)j * kr_step + b + a;
    vals[pos] = (u32)lane | (neg ? 0x80000000u : 0u);
    ++w;
  };
  auto digit = [&](u32 raw) {  // balanced digit, the carry moving into the next window
    const u32 d = raw + carry;
    const bool neg = d > half;
    carry = neg;
    put(neg ? (1u << c) - d : d, neg);
  };
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    acc |= (u64)__ldg(scalars + k * n + i) << nbits;
    nbits += 32;
    while (nbits >= c) {
      digit((u32)acc & mask);
      acc >>= c;
      nbits -= c;
    }
  }
  if (nbits > 0) digit((u32)acc);  // the top window, zero past the scalar's bits
  while (w < wp * f) put(0, false);  // dead slots of the merged layout
}

// keys, vals: (wp, n * f) words written; scalars (words, n) int32 read as
// uint32; base (n,) the lanes' group(l) * (H + 1). kr_step: KR, or 0 for
// keys of each window alone (sorted one window at a time).
extern "C" int snark_msm_sort_keys(void* keys, void* vals, const void* scalars, const void* base,
                                   long long n, int words, int c, int wp, int f,
                                   long long kr_step, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (words == 8) {
    msm_sort_keys_kernel<8><<<blocks, threads, 0, s>>>((u32*)keys, (u32*)vals,
                                                       (const u32*)scalars, (const u32*)base, n,
                                                       c, wp, f, (u32)kr_step);
  } else if (words == 12) {
    msm_sort_keys_kernel<12><<<blocks, threads, 0, s>>>((u32*)keys, (u32*)vals,
                                                        (const u32*)scalars, (const u32*)base, n,
                                                        c, wp, f, (u32)kr_step);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The temporary storage snark_msm_sort needs for n pairs over end_bit key
// bits, in bytes, written to *bytes (a host long long). Launches nothing.
extern "C" int snark_msm_sort_bytes(long long n, int end_bit, void* bytes) {
  size_t need = 0;
  msm_sort::cub::DoubleBuffer<u32> k(nullptr, nullptr), v(nullptr, nullptr);
  const cudaError_t err =
      msm_sort::cub::DeviceRadixSort::SortPairs(nullptr, need, k, v, (int)n, 0, end_bit);
  *(long long*)bytes = (long long)need;
  return (int)err;
}

// Sort n (key, value) pairs by key bits [0, end_bit), stable. The pairs
// start in keys / vals; *selector (a host int) is set to 0 where the sorted
// pairs end in keys / vals, 1 where they end in keys_alt / vals_alt. Both
// buffers are overwritten. n < 2^31.
extern "C" int snark_msm_sort(void* keys, void* keys_alt, void* vals, void* vals_alt,
                              long long n, int end_bit, void* temp, long long temp_bytes,
                              void* selector, void* stream) {
  msm_sort::cub::DoubleBuffer<u32> k((u32*)keys, (u32*)keys_alt), v((u32*)vals, (u32*)vals_alt);
  size_t bytes = (size_t)temp_bytes;
  const cudaError_t err = msm_sort::cub::DeviceRadixSort::SortPairs(
      temp, bytes, k, v, (int)n, 0, end_bit, (cudaStream_t)stream);
  *(int*)selector = k.selector;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
