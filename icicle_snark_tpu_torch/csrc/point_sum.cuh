// K6's per-block body: the lane-wise sum of S stacks of window sums in one
// fixed tree order, one launch (point_vec.cu). Plain C++ once the CUDA
// qualifiers are defined away: tests/test_torch_sharded_kernels_host_cuda.py
// runs it on the host, a std::thread a thread and a std::barrier for
// __syncthreads.
//
// The order is that of icicle_snark_tpu/ops/msm.py _roll_reduce (:335),
// which the mesh combine runs (_tree_reduce :408): the S stacks padded with
// identities (0 : 1 : 0) to P = 2^m, and level k adds element i + 2^k onto
// element i for i a multiple of 2^(k+1). The padding is added, not skipped:
// P + O is (XY : Y^2 : YZ), Y times P's words, and the plain version
// (ops/msm.py sum_windows_plain) adds it too, so the words agree.
//
// A block holds LB lanes and P / 2 tree threads a lane: (j, l) = j LB + l.
// Level 0: tree thread j adds elements 2j and 2j + 1, read from global
// memory (an identity past S). Level k >= 1, h = 2^(k-1): a thread with
// j mod 2h = h retires and writes its sum into shared slot j; after one
// barrier the thread with j mod 2h = 0 adds slot j + h. Each slot is
// written once and read once, so one barrier a level suffices. log2 P
// additions in a row, where the pairwise route made S - 1 launches of one.
//
// Shared slot j of a block: (3, C, 8, LB) words, the layout of a point
// array of LB lanes (p_load / p_store with n = LB), so a warp's lanes touch
// neighbouring words.
#pragma once
#include "curve_pair.cuh"

// lanes a block (fewer when the stacks are deep: P / 2 * LB <= 1024 threads)
#define POINT_SUM_LANES 32

// A launch over s >= 2 stacks of n lanes, 1 << shift threads a tree thread:
// half = P / 2 and lb, the lanes a block; blocks of (half << shift) * lb
// threads and half * W3 * lb words of shared memory (a lane layout's W3).
__host__ __device__ inline void point_sum_shape(long long s, long long n, int shift, int& half,
                                                int& lb) {
  half = 1;
  while (2LL * half < s) half <<= 1;
  lb = POINT_SUM_LANES;
  while (lb > 1 && (lb * half << shift) > 1024) lb >>= 1;
  if (lb > n) lb = (int)n;
}

// RCB15 alg 7 (curve.cuh p_add) on a thread pair (curve_pair.cuh): each
// thread holds one Fq component of x, y and z. An Fq2 product is one
// canonical element, so the words equal p_add<E2>'s (Karatsuba).
__device__ __forceinline__ Pt<E1> pair_add(const Pt<E1>& p, const Pt<E1>& q, PairLane pl) {
  E1 t0 = h_mul(p.x, q.x, pl);
  E1 t1 = h_mul(p.y, q.y, pl);
  E1 t2 = h_mul(p.z, q.z, pl);
  E1 ta = h_mul(e_add(p.x, p.y), e_add(q.x, q.y), pl);
  E1 tb = h_mul(e_add(p.y, p.z), e_add(q.y, q.z), pl);
  E1 tc = h_mul(e_add(p.x, p.z), e_add(q.x, q.z), pl);
  E1 t3 = e_sub(ta, e_add(t0, t1));
  E1 t4 = e_sub(tb, e_add(t1, t2));
  E1 t5 = e_sub(tc, e_add(t0, t2));
  E1 u = h_mul_b3(t2, pl);
  E1 y3m = h_mul_b3(t5, pl);
  E1 z3 = e_add(t1, u);
  E1 x3m = e_sub(t1, u);
  t0 = e_add(e_add(t0, t0), t0);
  Pt<E1> r;
  r.x = e_sub(h_mul(t3, x3m, pl), h_mul(t4, y3m, pl));
  r.y = e_add(h_mul(x3m, z3, pl), h_mul(t0, y3m, pl));
  r.z = e_add(h_mul(t4, z3, pl), h_mul(t3, t0, pl));
  return r;
}

// this thread's component of the identity (0 : 1 : 0) over Fq2
__device__ __forceinline__ Pt<E1> pair_identity(PairLane pl) {
  Pt<E1> r;
  e_set_zero(r.x);
  e_set_zero(r.z);
  if (pl.odd) e_set_zero(r.y);
  else e_set_one(r.y);
  return r;
}

// The two lane layouts of the tree. G1: one thread a lane, curve.cuh's
// p_add. G2: a pair of threads a lane (curve_pair.cuh), each holding one Fq
// component; on an H100 the pair summed 8 stacks in 0.153 ms against 0.243
// on one thread a lane (255 registers, 704 B of stack; PERF.md, Findings).
struct SumG1 {
  static constexpr int W3 = 24, SHIFT = 0;  // words a point; threads a lane, as a shift
  __device__ explicit SumG1(int) {}
  __device__ Pt<E1> identity() const { return p_identity<E1>(); }
  __device__ Pt<E1> load(const u32* b, long long n, long long i) const { return p_load<E1>(b, n, i); }
  __device__ void store(u32* b, long long n, long long i, const Pt<E1>& p) const {
    p_store(b, n, i, p);
  }
  __device__ Pt<E1> add(const Pt<E1>& p, const Pt<E1>& q) const { return p_add(p, q); }
};

struct SumG2Pair {
  static constexpr int W3 = 48, SHIFT = 1;
  PairLane pl;
  __device__ explicit SumG2Pair(int) : pl(pair_lane()) {}
  __device__ Pt<E1> identity() const { return pair_identity(pl); }
  __device__ Pt<E1> load(const u32* b, long long n, long long i) const {
    return pair_load(b, n, i, pl);
  }
  __device__ void store(u32* b, long long n, long long i, const Pt<E1>& p) const {
    pair_store(b, n, i, pl, p);
  }
  __device__ Pt<E1> add(const Pt<E1>& p, const Pt<E1>& q) const { return pair_add(p, q, pl); }
};

// Thread t of block `block` (t >> L::SHIFT is the tree thread (j, l)); sm:
// half * L::W3 * lb words. The addition has one call site: the thread of
// level h adds while j is a multiple of h, its partner's sum read from the
// slot written before the level's barrier.
template <class L>
__device__ __forceinline__ void point_sum_body(u32* out, const u32* in, long long s, long long n,
                                               int half, int lb, long long block, int t,
                                               u32* sm) {
  const L lane(t);
  const int u = t >> L::SHIFT, l = u % lb, j = u / lb;
  const long long i = block * lb + l, stride = (long long)L::W3 * n;
  const bool live = i < n;
  auto acc = lane.identity(), q = lane.identity();
  if (live && 2 * j < s) acc = lane.load(in + 2 * j * stride, n, i);
  if (live && 2 * j + 1 < s) q = lane.load(in + (2 * j + 1) * stride, n, i);
  for (int h = 1;; h <<= 1) {
    if ((j & (h - 1)) == 0) acc = lane.add(acc, q);
    if (h >= half) break;
    if ((j & (2 * h - 1)) == h) lane.store(sm + (long long)j * L::W3 * lb, lb, l, acc);
    __syncthreads();
    if ((j & (2 * h - 1)) == 0) q = lane.load(sm + (long long)(j + h) * L::W3 * lb, lb, l);
  }
  if (j == 0 && live) lane.store(out, n, i, acc);
}
