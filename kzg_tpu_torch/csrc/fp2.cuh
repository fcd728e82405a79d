// Device-side Fp2 = Fp[w]/(w^2 + 1) arithmetic over mont.cuh (BN254's
// quadratic extension, qnr = -1), the dataflow of
// kzg_tpu_torch/fields/quadratic.py Fp2 (kzg_tpu/fields/quadratic.py).
//
// An element is two Fe components (c0 + c1 w); a batch of them is
// int64[2, L, lanes] (component axis first, then the base field's
// limb-major layout). Subtractions are exact, as Fp2.sub (lazy=False):
// a + k p - b with a full signed carry chain, giving exact 16-bit limbs
// and the value a + k p - b, which needs value(b) <= k p. The product is
// Karatsuba with three base products: c0 = v0 - v1 + 2 p, c1 = t - v0 - v1
// + 4 p (components <= 5.6 p, exact 16-bit limbs), as Fp2.mul.
//
// Register budget of a G2 point operation in ONE thread (K6's combine,
// msm_merge.cu, through g2.cuh): an Fp2 value is 34 words, so the point
// operation cannot live in registers. The base product is one __noinline__
// function (the one unrolled 17 x 17 product of the module): its operands
// are passed by address and live in the thread's local memory (a stack
// frame of 2.3-3.8 KB, cached in L1 as far as it holds), and the rest of
// the point operation spills there too. That bounds registers and nvcc's
// time; the local-memory traffic and the one thread's serial chain of 48
// products per add bound its speed. K4/K5 left this design for lane teams
// (team.cuh), which share mont.cuh's fe_sub_exact with it.
#pragma once

#include "mont.cuh"

namespace kzg {

struct Fe2 {
  Fe c0, c1;
};

// Base field constants of the Fp2 product: the modulus block and the exact
// 16-bit limbs of 2 p and 4 p (the slacks of its two output subtractions).
struct Fp2Mod {
  Mod M;
  uint32_t kp2[L];
  uint32_t kp4[L];
};

// One Montgomery product, not inlined (see the register budget above).
static __device__ __noinline__ void fe_mul_ni(Fe& o, const Fe& a,
                                              const Fe& b, const Mod& M) {
  mont_mul(o, a, b, M);
}

__device__ __forceinline__ void fp2_add(Fe2& o, const Fe2& a, const Fe2& b) {
  fe_add(o.c0, a.c0, b.c0);
  fe_add(o.c1, a.c1, b.c1);
}

// Exact sub with the same k p slack on both components (Fp2.sub(k)).
__device__ __forceinline__ void fp2_sub(Fe2& o, const Fe2& a, const Fe2& b,
                                        const uint32_t* kp) {
  fe_sub_exact(o.c0, a.c0, b.c0, kp);
  fe_sub_exact(o.c1, a.c1, b.c1, kp);
}

__device__ __forceinline__ void fp2_small(Fe2& o, const Fe2& a, uint32_t s) {
  fe_small(o.c0, a.c0, s);
  fe_small(o.c1, a.c1, s);
}

// Karatsuba product with qnr = -1 (Fp2.mul). o may alias a or b.
__device__ __forceinline__ void fp2_mul(Fe2& o, const Fe2& a, const Fe2& b,
                                        const Fp2Mod& F) {
  Fe sa, sb, v0, v1, t, s;
  fe_add(sa, a.c0, a.c1);
  fe_add(sb, b.c0, b.c1);
  fe_mul_ni(v0, a.c0, b.c0, F.M);
  fe_mul_ni(v1, a.c1, b.c1, F.M);
  fe_mul_ni(t, sa, sb, F.M);
  fe_sub_exact(o.c0, v0, v1, F.kp2);   // v0 + qnr v1, qnr = -1
  fe_add(s, v0, v1);
  fe_sub_exact(o.c1, t, s, F.kp4);     // (a0 + a1)(b0 + b1) - v0 - v1
}

// Re-reduce both components: exact 16-bit limbs, value < 1.1 p.
__device__ __forceinline__ void fp2_fresh(Fe2& o, const Fe2& a,
                                          const Mod& M) {
  Fe one;
#pragma unroll
  for (int k = 0; k < L; ++k) one.v[k] = M.one[k];
  fe_mul_ni(o.c0, a.c0, one, M);
  fe_mul_ni(o.c1, a.c1, one, M);
}

// An Fp2 batch is int64[2, L, lanes]: component c, limb k of lane i at
// (c L + k) lanes + i.
__device__ __forceinline__ void fe2_load(Fe2& x, const int64_t* base,
                                         int64_t lanes, int64_t i) {
  fe_load(x.c0, base, lanes, i);
  fe_load(x.c1, base + (int64_t)L * lanes, lanes, i);
}

__device__ __forceinline__ void fe2_store(int64_t* base, const Fe2& x,
                                          int64_t lanes, int64_t i) {
  fe_store(base, x.c0, lanes, i);
  fe_store(base + (int64_t)L * lanes, x.c1, lanes, i);
}

}  // namespace kzg
