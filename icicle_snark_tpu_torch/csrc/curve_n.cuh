// G1 / G2 coordinate types of bls12-377, bls12-381 and bw6-761 for the point
// formulas of curve.cuh (Pt<E>, p_add_inl, p_add, p_madd, p_dbl), which
// apply to them as they stand: each type has e_add / e_sub / e_mul / e_neg /
// e_is_zero / e_mul_b3 / e_set_zero / e_set_one / e_load / e_store, an
// ECoord word count and a rec_load for the lane-major records of
// ops/msm.py point_records.
//
// Replaces icicle_snark_tpu/curves/device.py LimbFieldOps (:41; mul_many
// :62, the small-b3 chain _mul_b3_small :94) and LimbFq2Ops (:110; _mul_nr
// :127, the Karatsuba mul_many :158), the field tables that the JAX package
// ran the BN254 point formulas and MSM pipeline over.
//
//   type     group              coordinates            b3 = 3b
//   E377     bls12-377 G1       Fq, 12 words           3
//   E377_2   bls12-377 G2       Fq2, u^2 = -5          (0, 3 b2): two products by a constant
//   E381     bls12-381 G1       Fq, 12 words           12
//   E381_2   bls12-381 G2       Fq2, u^2 = -1          (12, 12)
//   E761     bw6-761 G1         Fq, 24 words           -3 (b = -1)
//   E761_2   bw6-761 G2         Fq (M-twist), 24 words 12 (b = 4)
//
// Small constants multiply by addition chains, as the JAX package's
// _mul_nr and _mul_b3_small do; any exact formula gives the same canonical
// words, so the plain versions (curves/device.py) agree word for word.
// Products go through nmul_call, __noinline__ (field_n.cuh).
#pragma once
#include "curve.cuh"
#include "field_n.cuh"

// k * x mod p for a small constant k (double-and-add on sums; k < 0 negates)
template <class F, int K>
__device__ __forceinline__ Fe<F> fe_small(const Fe<F>& x) {
  constexpr int A = K < 0 ? -K : K;
  Fe<F> acc, cur = x;
  bool have = false;
#pragma unroll
  for (int k = A; k; k >>= 1) {
    if (k & 1) {
      if (have) nadd<F>(acc.v, acc.v, cur.v);
      else acc = cur;
      have = true;
    }
    if (k >> 1) nadd<F>(cur.v, cur.v, cur.v);
  }
  if (K < 0) nneg<F>(acc.v, acc.v);
  return acc;
}

// ---------------------------------------------------------------- Fq coordinates
// G: the group's traits, F its field and B3 its small b3.
template <class G>
struct EF {
  Fe<typename G::F> a;
};

template <class G>
__device__ __forceinline__ EF<G> e_add(const EF<G>& x, const EF<G>& y) { EF<G> r; nadd<typename G::F>(r.a.v, x.a.v, y.a.v); return r; }
template <class G>
__device__ __forceinline__ EF<G> e_sub(const EF<G>& x, const EF<G>& y) { EF<G> r; nsub<typename G::F>(r.a.v, x.a.v, y.a.v); return r; }
template <class G>
__device__ __forceinline__ EF<G> e_mul(const EF<G>& x, const EF<G>& y) { return {nmul_call<typename G::F>(x.a, y.a)}; }
template <class G>
__device__ __forceinline__ EF<G> e_neg(const EF<G>& x) { EF<G> r; nneg<typename G::F>(r.a.v, x.a.v); return r; }
template <class G>
__device__ __forceinline__ bool e_is_zero(const EF<G>& x) { return n_is_zero<typename G::F>(x.a.v); }
template <class G>
__device__ __forceinline__ EF<G> e_mul_b3(const EF<G>& x) { return {fe_small<typename G::F, G::B3>(x.a)}; }
template <class G>
__device__ __forceinline__ void e_set_zero(EF<G>& x) {
#pragma unroll
  for (int k = 0; k < G::F::N; k++) x.a.v[k] = 0;
}
template <class G>
__device__ __forceinline__ void e_set_one(EF<G>& x) {
#pragma unroll
  for (int k = 0; k < G::F::N; k++) x.a.v[k] = G::F::one(k);
}
template <class G>
__device__ __forceinline__ void e_load(EF<G>& x, const u32* base, long long n, long long i) { nload<typename G::F>(x.a.v, base, n, i); }
template <class G>
__device__ __forceinline__ void e_store(u32* base, long long n, long long i, const EF<G>& x) { nstore<typename G::F>(base, n, i, x.a.v); }

template <class G> struct ECoord<EF<G>> { static constexpr int WORDS = G::F::N; };

// records of 2N words: x | y
template <class G>
__device__ __forceinline__ void rec_load(EF<G>& x, EF<G>& y, const u32* __restrict__ rec, long long lane) {
  constexpr int N = G::F::N;
  u32 w[2 * N];
  rec_words(w, rec, lane);
#pragma unroll
  for (int k = 0; k < N; k++) { x.a.v[k] = w[k]; y.a.v[k] = w[N + k]; }
}

// ---------------------------------------------------------------- Fq2 coordinates
// u^2 = G::NR (a small negative integer); G::mul_b3 multiplies by 3 b2.
template <class G>
struct EF2 {
  Fe<typename G::F> c0, c1;
};

template <class G>
__device__ __forceinline__ EF2<G> e_add(const EF2<G>& x, const EF2<G>& y) {
  using F = typename G::F;
  EF2<G> r;
  nadd<F>(r.c0.v, x.c0.v, y.c0.v);
  nadd<F>(r.c1.v, x.c1.v, y.c1.v);
  return r;
}
template <class G>
__device__ __forceinline__ EF2<G> e_sub(const EF2<G>& x, const EF2<G>& y) {
  using F = typename G::F;
  EF2<G> r;
  nsub<F>(r.c0.v, x.c0.v, y.c0.v);
  nsub<F>(r.c1.v, x.c1.v, y.c1.v);
  return r;
}
template <class G>
__device__ __forceinline__ EF2<G> e_neg(const EF2<G>& x) {
  using F = typename G::F;
  EF2<G> r;
  nneg<F>(r.c0.v, x.c0.v);
  nneg<F>(r.c1.v, x.c1.v);
  return r;
}
// Karatsuba, as LimbFq2Ops.mul_many: (T0 + nr T1) + (T2 - T0 - T1) u
template <class G>
__device__ __forceinline__ EF2<G> e_mul(const EF2<G>& x, const EF2<G>& y) {
  using F = typename G::F;
  Fe<F> sx, sy;
  nadd<F>(sx.v, x.c0.v, x.c1.v);
  nadd<F>(sy.v, y.c0.v, y.c1.v);
  Fe<F> t0 = nmul_call<F>(x.c0, y.c0);
  Fe<F> t1 = nmul_call<F>(x.c1, y.c1);
  Fe<F> t2 = nmul_call<F>(sx, sy);
  EF2<G> r;
  Fe<F> nt1 = fe_small<F, G::NR>(t1);
  nadd<F>(r.c0.v, t0.v, nt1.v);
  nadd<F>(t0.v, t0.v, t1.v);
  nsub<F>(r.c1.v, t2.v, t0.v);
  return r;
}
template <class G>
__device__ __forceinline__ bool e_is_zero(const EF2<G>& x) {
  return n_is_zero<typename G::F>(x.c0.v) && n_is_zero<typename G::F>(x.c1.v);
}
template <class G>
__device__ __forceinline__ EF2<G> e_mul_b3(const EF2<G>& x) { return G::mul_b3(x); }
template <class G>
__device__ __forceinline__ void e_set_zero(EF2<G>& x) {
#pragma unroll
  for (int k = 0; k < G::F::N; k++) { x.c0.v[k] = 0; x.c1.v[k] = 0; }
}
template <class G>
__device__ __forceinline__ void e_set_one(EF2<G>& x) {
#pragma unroll
  for (int k = 0; k < G::F::N; k++) { x.c0.v[k] = G::F::one(k); x.c1.v[k] = 0; }
}
// Fq2 arrays are (2, N, n): component c at c * N * n
template <class G>
__device__ __forceinline__ void e_load(EF2<G>& x, const u32* base, long long n, long long i) {
  nload<typename G::F>(x.c0.v, base, n, i);
  nload<typename G::F>(x.c1.v, base + G::F::N * n, n, i);
}
template <class G>
__device__ __forceinline__ void e_store(u32* base, long long n, long long i, const EF2<G>& x) {
  nstore<typename G::F>(base, n, i, x.c0.v);
  nstore<typename G::F>(base + G::F::N * n, n, i, x.c1.v);
}

template <class G> struct ECoord<EF2<G>> { static constexpr int WORDS = 2 * G::F::N; };

// records of 4N words: x.c0 | x.c1 | y.c0 | y.c1
template <class G>
__device__ __forceinline__ void rec_load(EF2<G>& x, EF2<G>& y, const u32* __restrict__ rec, long long lane) {
  constexpr int N = G::F::N;
  u32 w[4 * N];
  rec_words(w, rec, lane);
#pragma unroll
  for (int k = 0; k < N; k++) {
    x.c0.v[k] = w[k]; x.c1.v[k] = w[N + k]; y.c0.v[k] = w[2 * N + k]; y.c1.v[k] = w[3 * N + k];
  }
}

// ---------------------------------------------------------------- the six groups
struct G377 { using F = Bls377Fq; static constexpr int B3 = 3; };
struct G381 { using F = Bls381Fq; static constexpr int B3 = 12; };
struct G761 { using F = Bw6Fq; static constexpr int B3 = -3; };
struct G761_2 { using F = Bw6Fq; static constexpr int B3 = 12; };

struct G377_2 {
  using F = Bls377Fq;
  static constexpr int NR = -5;
  // (x0 + x1 u) (c u) = nr c x1 + c x0 u, c = 3 b2.c1 in Montgomery form
  __device__ static __forceinline__ EF2<G377_2> mul_b3(const EF2<G377_2>& x) {
    Fe<F> c;
    const u32 C[12] = {0x3333338fu, 0x81567333u, 0x9cccccfcu, 0xa9e00b73u, 0x82ed9e6eu, 0x7fad0250u, 0x24aed052u, 0x2c18f48au, 0xf43c75cbu, 0xe25d7666u, 0x52ddddc9u, 0x00ad4befu};
#pragma unroll
    for (int k = 0; k < 12; k++) c.v[k] = C[k];
    EF2<G377_2> r;
    r.c0 = fe_small<F, NR>(nmul_call<F>(c, x.c1));
    r.c1 = nmul_call<F>(c, x.c0);
    return r;
  }
};

struct G381_2 {
  using F = Bls381Fq;
  static constexpr int NR = -1;
  // (12 + 12 u)(x0 + x1 u) = 12 (x0 - x1) + 12 (x0 + x1) u
  __device__ static __forceinline__ EF2<G381_2> mul_b3(const EF2<G381_2>& x) {
    Fe<F> d, s;
    nsub<F>(d.v, x.c0.v, x.c1.v);
    nadd<F>(s.v, x.c0.v, x.c1.v);
    return {fe_small<F, 12>(d), fe_small<F, 12>(s)};
  }
};

typedef EF<G377> E377;
typedef EF2<G377_2> E377_2;
typedef EF<G381> E381;
typedef EF2<G381_2> E381_2;
typedef EF<G761> E761;
typedef EF<G761_2> E761_2;
