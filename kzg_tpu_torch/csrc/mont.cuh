// Device-side Montgomery field arithmetic shared by the port's kernels.
//
// Layout (the JAX package's): a field element batch is limb-major
// int64[L, lanes], little-endian base-2^16 limbs in the Montgomery domain
// with R = 2^(16 L). One thread owns one lane; thread i reads limb k at
// k * lanes + i, so neighbouring threads read neighbouring addresses.
//
// The limb count L is fixed at compile time by -DKZG_L (17 when unset):
// 17 for BN254's Fp and Fr and BLS12-381's Fr, 25 for BLS12-381's Fp, 11
// for BN158's Fp and Fr (kzg_tpu_torch/ops/cuda.py builds each source once
// per limb count). Nothing here depends on L beyond its use as a count.
//
// Value bounds (kzg_tpu_torch/fields/mont.py states them as measured):
//   mont_mul inputs: limbs < 2^22, so each 64-bit column stays below
//   2 L 2^44; the output is exact 16-bit limbs of (a b + m p) / R <
//   a b / R + p: below 1.1 p for inputs below 64 p (R >= 2^16 p), below
//   2 p while a b < R p (every product on BN254 and BN158), and below
//   2.14 p on BLS12-381, whose G1 add gives one product a b = 1.14 R p.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef KZG_L
#define KZG_L 17
#endif

namespace kzg {

constexpr int L = KZG_L;           // limbs per field element
constexpr uint32_t MASK16 = 0xFFFFu;

// Modulus constants, passed by value as a kernel parameter (constant bank).
struct Mod {
  uint32_t p[L];
  uint32_t one[L];                 // R mod p: Montgomery form of 1
  uint32_t n0;                     // -p^-1 mod 2^16
};

struct Fe {
  uint32_t v[L];
};

__device__ __forceinline__ void fe_load(Fe& x, const int64_t* base,
                                        int64_t lanes, int64_t i) {
#pragma unroll
  for (int k = 0; k < L; ++k) x.v[k] = (uint32_t)base[k * lanes + i];
}

__device__ __forceinline__ void fe_store(int64_t* base, const Fe& x,
                                         int64_t lanes, int64_t i) {
#pragma unroll
  for (int k = 0; k < L; ++k) base[k * lanes + i] = (int64_t)x.v[k];
}

// Montgomery product a b R^-1: L x L product columns in 64-bit
// accumulators (each < L * 2^44), then L rounds of base-2^16 reduction
// (m = t_i n0 mod 2^16; t += m p 2^(16 i); carry t_i up), then the exact
// carry chain of the high half. No final conditional subtraction.
__device__ __forceinline__ void mont_mul(Fe& out, const Fe& a, const Fe& b,
                                         const Mod& M) {
  uint64_t t[2 * L];
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) t[i + j] += (uint64_t)a.v[i] * b.v[j];
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t m = ((t[i] & MASK16) * M.n0) & MASK16;
#pragma unroll
    for (int j = 0; j < L; ++j) t[i + j] += m * M.p[j];
    t[i + 1] += t[i] >> 16;
  }
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const uint64_t v = t[L + k] + c;
    out.v[k] = (uint32_t)(v & MASK16);
    c = v >> 16;
  }
}

// Lazy add: limbwise, bounds add.
__device__ __forceinline__ void fe_add(Fe& o, const Fe& a, const Fe& b) {
#pragma unroll
  for (int k = 0; k < L; ++k) o.v[k] = a.v[k] + b.v[k];
}

// Lazy multiply by a small integer (value and limbs scale by s).
__device__ __forceinline__ void fe_small(Fe& o, const Fe& a, uint32_t s) {
#pragma unroll
  for (int k = 0; k < L; ++k) o.v[k] = a.v[k] * s;
}

// Lazy sub: a + lift - b, then two local 16-bit carry passes. `lift` is the
// limb-lifted multiple of p of Field.lift_limbs(k): every non-top limb is
// >= 2^20 - 16 >= any limb of b, so no limb goes negative. Output limbs
// <= 2^16 + 1, value <= value(a) + m p.
__device__ __forceinline__ void fe_sub(Fe& o, const Fe& a, const Fe& b,
                                       const uint32_t* lift) {
  uint32_t d[L];
#pragma unroll
  for (int k = 0; k < L; ++k) d[k] = a.v[k] + lift[k] - b.v[k];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint32_t hi = d[k] >> 16;
      d[k] = (d[k] & MASK16) + carry;
      carry = hi;
    }
  }
#pragma unroll
  for (int k = 0; k < L; ++k) o.v[k] = d[k];
}

// Exact a + kp - b: exact 16-bit limbs, value a + kp - b (value(b) <= kp).
// Limbs of a and b below 2^30; the running carry is signed.
__device__ __forceinline__ void fe_sub_exact(Fe& o, const Fe& a, const Fe& b,
                                             const uint32_t* kp) {
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int64_t d = (int64_t)a.v[k] + (int64_t)kp[k] - (int64_t)b.v[k] + c;
    o.v[k] = (uint32_t)(d & MASK16);
    c = d >> 16;                       // arithmetic: floor division
  }
}

// Re-reduce to exact 16-bit limbs, value < 1.1 p (times Montgomery 1).
__device__ __forceinline__ void fe_fresh(Fe& o, const Fe& a, const Mod& M) {
  Fe one;
#pragma unroll
  for (int k = 0; k < L; ++k) one.v[k] = M.one[k];
  mont_mul(o, a, one, M);
}

// Host side: constants arrive as one uint32 array from the Python wrapper
// (kzg_tpu_torch/ops/cuda.py builds it): p[L], one[L], n0.
inline Mod mod_from_host(const uint32_t* h) {
  Mod M;
  for (int k = 0; k < L; ++k) M.p[k] = h[k];
  for (int k = 0; k < L; ++k) M.one[k] = h[L + k];
  M.n0 = h[2 * L];
  return M;
}

// Error code the C entry points return for a limb count they were not
// instantiated for (CUDA's own codes are below 1000).
constexpr int BAD_LIMBS = 1001;

}  // namespace kzg
