// K8: register-resident dependent-chain throughput probe.
//
// Replaces the two Pallas probes of the JAX package,
// tools/pallas_microbench.py make_pallas_chain (:53) and
// tools/vpu_ceiling_probe.py pallas_probe (:105): a block held in the TPU's
// VMEM with `x = op(x, y)` applied DEPTH times, and the ILP variant with W
// independent chains. On Hopper the counterpart of "resident in fast memory"
// is the register file: every thread keeps W independent chains in registers,
// applies the op `depth` times to each, and writes the final words, so the
// only traffic is two loads and W stores per thread.
//
// Ops (the instruction sequences are fixed with inline PTX so that neither
// nvcc nor ptxas can fold a chain into a closed form):
//   0  mul.lo.u32                 x = x * y
//   1  add.u32                    x = x + y
//   2  mul.lo.u32 + and.b32       x = (x * y) & 0xFFFF
//   3  mad.lo.cc.u32 / madc.hi.u32  (hi, lo) = lo * y + hi   (the 32 x 32 ->
//      64 multiply-accumulate step of the CIOS product in field.cuh; the
//      stored word is lo ^ hi)
//   4  fma.rn.f32                 x = x * y + y
// Chain w starts from x + w (x + w as float for op 4; hi = w for op 3).
//
// Bound: operations, by construction. One (op, W) run issues
// n * W * depth ops (op 3: two multiply instructions per op) against
// 8 (1 + W) bytes per thread. With `-Xptxas -v` the kernels report no spills
// and no stack (12 to 36 registers). `cuobjdump -sass` of the sm_90a object
// (CUDA 12.8), checked once, shows nothing hoisted or merged: the W = 8
// kernels hold 73 IMAD for mul (8 chains x 8 unrolled steps, the remainder
// loop's 8, one for the index), 69 IADD3/VIADD for add, 76 IMAD + 74 LOP3 for
// mul + and, 127 IMAD for the mad pair (two per step) and 72 FFMA for fma.
#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;

template <int OP>
struct Chain {
  u32 lo, hi;
  float f;
  __device__ __forceinline__ void init(u32 x, float xf, int w) {
    f = xf + (float)w;
    if (OP == 4) {
      lo = hi = 0;
    } else {
      lo = x + (u32)w;
      hi = (OP == 3) ? (u32)w : 0u;
    }
  }
  __device__ __forceinline__ void step(u32 y) {
    if (OP == 0) {
      asm("mul.lo.u32 %0, %0, %1;" : "+r"(lo) : "r"(y));
    } else if (OP == 1) {
      asm("add.u32 %0, %0, %1;" : "+r"(lo) : "r"(y));
    } else if (OP == 2) {
      asm("mul.lo.u32 %0, %0, %1;\n\tand.b32 %0, %0, 65535;" : "+r"(lo) : "r"(y));
    } else if (OP == 3) {
      u32 nlo, nhi;
      asm("mad.lo.cc.u32 %0, %2, %3, %4;\n\tmadc.hi.u32 %1, %2, %3, 0;"
          : "=r"(nlo), "=r"(nhi)
          : "r"(lo), "r"(y), "r"(hi));
      lo = nlo;
      hi = nhi;
    } else {
      asm("fma.rn.f32 %0, %0, %1, %1;" : "+f"(f) : "f"(__uint_as_float(y)));
    }
  }
  __device__ __forceinline__ u32 result() const {
    return OP == 4 ? __float_as_uint(f) : (OP == 3 ? (lo ^ hi) : lo);
  }
};

template <int OP, int W>
__global__ void probe_chain_kernel(u32* __restrict__ out, const u32* __restrict__ x,
                                   const u32* __restrict__ y, long long n, int depth) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 xi = x[i], yi = y[i];
  Chain<OP> c[W];
#pragma unroll
  for (int w = 0; w < W; w++) c[w].init(xi, __uint_as_float(xi), w);
#pragma unroll 8
  for (int d = 0; d < depth; d++) {
#pragma unroll
    for (int w = 0; w < W; w++) c[w].step(yi);
  }
#pragma unroll
  for (int w = 0; w < W; w++) out[(long long)w * n + i] = c[w].result();
}

template <int OP>
static int launch_width(int width, u32* out, const u32* x, const u32* y, long long n, int depth,
                        cudaStream_t s) {
  int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  switch (width) {
    case 1: probe_chain_kernel<OP, 1><<<blocks, threads, 0, s>>>(out, x, y, n, depth); break;
    case 2: probe_chain_kernel<OP, 2><<<blocks, threads, 0, s>>>(out, x, y, n, depth); break;
    case 4: probe_chain_kernel<OP, 4><<<blocks, threads, 0, s>>>(out, x, y, n, depth); break;
    case 8: probe_chain_kernel<OP, 8><<<blocks, threads, 0, s>>>(out, x, y, n, depth); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out (W, n) words; x, y (n,) words (float32 bit patterns for op 4).
extern "C" int snark_probe_chain(int op, int width, void* out, const void* x, const void* y,
                                 long long n, int depth, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  u32* o = (u32*)out;
  const u32 *xp = (const u32*)x, *yp = (const u32*)y;
  switch (op) {
    case 0: return launch_width<0>(width, o, xp, yp, n, depth, s);
    case 1: return launch_width<1>(width, o, xp, yp, n, depth, s);
    case 2: return launch_width<2>(width, o, xp, yp, n, depth, s);
    case 3: return launch_width<3>(width, o, xp, yp, n, depth, s);
    case 4: return launch_width<4>(width, o, xp, yp, n, depth, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
