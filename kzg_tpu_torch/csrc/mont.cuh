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

constexpr int D32 = (L + 1) / 2;   // 32-bit digits of an element (the
                                   // digit product below)

// Modulus constants, passed by value as a kernel parameter (constant bank).
struct Mod {
  uint32_t p[L];
  uint32_t one[L];                 // R mod p: Montgomery form of 1
  uint32_t n0;                     // -p^-1 mod 2^16
  uint32_t n1;                     // -p^-1 mod 2^32 (n0 its low half)
  uint32_t p32[D32 - 1];           // p in 32-bit digits (limb L - 1 of p
                                   // is 0: R >= 2^16 p)
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
//
// Every product here (mont_mul, mont_mul_d32 and split_mul below) returns
// the same limbs: the exact 16-bit limbs of (a b + M p) / R mod R, where M
// is the one integer in [0, R) with a b + M p = 0 mod R (M = -a b p^-1 mod
// R). Rounds of any digit size that together clear the low 16 L bits
// build that M, so the digit size of the rounds does not change the
// output.
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

// ----------------------------------------------------------------------
// The digit product: a b R^-1 on D32 = (L + 1) / 2 digits of 32 bits, one
// thread, in PTX carry chains (the lane executor's product in K6 at 25
// limbs, msm_merge.cu MERGE_DIGITS). L is odd at every
// limb count built (17, 25, 11), so the top digit holds limb L - 1 and its
// carry, and p fits D32 - 1 digits. The rounds are interleaved with the
// product's rows (CIOS): round i adds a_i b, takes m = t_0 n1 mod 2^32,
// adds m p and drops the cleared low digit, D32 - 1 rounds of 32 bits,
// then the last row and a round of 16 bits (m = t_0 n1 mod 2^16) whose
// quotient is read off at a 16-bit offset: R = 2^(32 (D32 - 1) + 16) =
// 2^(16 L). The output equals mont_mul's limb for limb (the note above).
// Bounds: limbs below 2^22 give a, b < 2^(16 L + 7) in D32 digits (the top
// one below 2^23); the accumulator t stays below b + p < 2^(16 L + 8)
// between rounds and below 2^(32 D32 + 24) inside one, so D32 + 1 words
// hold it and no chain carries out of the top word.
// ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t d;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d)
               : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d)
               : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t d;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d)
               : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d)
               : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(d)
               : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t addc_cc(uint32_t a) {
  uint32_t d;
  asm volatile("addc.cc.u32 %0, %1, 0;" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ uint32_t addc(uint32_t a) {
  uint32_t d;
  asm volatile("addc.u32 %0, %1, 0;" : "=r"(d) : "r"(a));
  return d;
}

// t (D32 + 1 words) += x y, y of N <= D32 digits: the low halves of x y_j
// in one carry chain from t_0, the high halves in another from t_1, each
// chain's carry run up to the top word.
template <int N>
__device__ __forceinline__ void row_mad(uint32_t (&t)[D32 + 1], uint32_t x,
                                        const uint32_t* y) {
  t[0] = mad_lo_cc(x, y[0], t[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(x, y[j], t[j]);
#pragma unroll
  for (int k = N; k < D32; ++k) t[k] = addc_cc(t[k]);
  t[D32] = addc(t[D32]);
  t[1] = mad_hi_cc(x, y[0], t[1]);
#pragma unroll
  for (int j = 1; j < N; ++j) {
    if (j + 1 < D32)
      t[j + 1] = madc_hi_cc(x, y[j], t[j + 1]);
    else
      t[D32] = madc_hi(x, y[j], t[D32]);
  }
#pragma unroll
  for (int k = N + 1; k < D32; ++k) t[k] = addc_cc(t[k]);
  if (N < D32) t[D32] = addc(t[D32]);
}

// Lazy 16-bit limbs (below 2^22) -> D32 exact 32-bit digits.
__device__ __forceinline__ void to_digits(uint32_t (&x)[D32], const Fe& a) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < D32 - 1; ++j) {
    c += (uint64_t)a.v[2 * j] + ((uint64_t)a.v[2 * j + 1] << 16);
    x[j] = (uint32_t)c;
    c >>= 32;
  }
  x[D32 - 1] = a.v[L - 1] + (uint32_t)c;
}

__device__ __forceinline__ void mont_mul_d32(Fe& out, const Fe& a,
                                             const Fe& b, const Mod& M) {
  static_assert(L % 2 == 1, "the digit product takes an odd limb count");
  uint32_t x[D32], y[D32], t[D32 + 1];
  to_digits(x, a);
  to_digits(y, b);
#pragma unroll
  for (int k = 0; k <= D32; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < D32; ++i) {
    row_mad<D32>(t, x[i], y);
    uint32_t m = t[0] * M.n1;
    if (i == D32 - 1) m &= MASK16;      // the last round: 16 bits
    row_mad<D32 - 1>(t, m, M.p32);
    if (i < D32 - 1) {                   // t_0 is 0: drop it
#pragma unroll
      for (int k = 0; k < D32; ++k) t[k] = t[k + 1];
      t[D32] = 0;
    }
  }
  // t is 0 mod 2^16: the quotient's limbs, mod R
#pragma unroll
  for (int j = 0; j < D32; ++j) {
    out.v[2 * j] = t[j] >> 16;
    if (2 * j + 1 < L) out.v[2 * j + 1] = t[j + 1] & MASK16;
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

// ----------------------------------------------------------------------
// The split product: one Montgomery product a b R^-1 computed by a team of
// T threads (*ranks*, T dividing 32) of one warp, K1's lane-team variant
// (mont_mul.cu) and the split executor of the point kernels (team.cuh).
// Rank r owns product columns [r C, r C + C), C = ceil(2 L / T), and
// accumulates them in 64-bit registers over a sliding window of b; in
// reduction round i the owner of column i takes m_i and its carry. Inside
// its range it adds both into its column i + 1 at once, so its chain of
// rounds waits on no shuffle, and m_i reaches the other columns one round
// later; at the end of its range m_i and the carry go to every rank in one
// 64-bit shuffle. Then each rank that owns high columns normalizes them;
// its carry moves into the next rank's digits in one to three shuffles
// until every carry is 0 or 1, and a carry-lookahead over two ballots
// settles the rest. kzg_tpu_torch/ops/k1_team.py models it on the CPU;
// the output is limb for limb mont_mul's.
// ----------------------------------------------------------------------

template <int T>
struct SplitShape {
  static constexpr int C = (2 * L + T - 1) / T;   // columns per rank
  static constexpr int W = L + C;                  // a rank's window of b, p
  static constexpr int PZ = T * C + L - 1;         // words of the padded p
};

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  const uint32_t lo = __shfl_sync(0xFFFFFFFFu, (uint32_t)v, src);
  const uint32_t hi = __shfl_sync(0xFFFFFFFFu, (uint32_t)(v >> 32), src);
  return ((uint64_t)hi << 32) | lo;
}

// Rank `rank` of a team whose rank 0 is warp lane `lead`. Every thread of
// the warp calls it at once (its shuffles and ballots name the whole warp).
// ar: a's L limbs; bw[z] = b_(c0 - (L - 1) + z), zero outside [0, L), c0 =
// rank C; pw(z) = p_(c0 - (L - 1) + z) at pz[z], zero outside [0, L), for z
// < W - 1. On return t[q] holds output limb c0 + q - L (exact 16 bits) for
// each of the rank's columns c0 + q in [L, 2 L).
template <int T>
__device__ __forceinline__ void split_mul(uint64_t (&t)[SplitShape<T>::C],
                                          const uint32_t (&ar)[L],
                                          const uint32_t (&bw)[
                                              SplitShape<T>::W - 1],
                                          const uint32_t* pz, int rank,
                                          int lead, const Mod& M) {
  constexpr int C = SplitShape<T>::C, W = SplitShape<T>::W;
  const int c0 = rank * C;

  // product: slot q holds column c0 + q = sum_x a_x b_(c0 + q - x)
#pragma unroll
  for (int q = 0; q < C; ++q) t[q] = 0;
#pragma unroll
  for (int x = 0; x < L; ++x) {
#pragma unroll
    for (int q = 0; q < C; ++q) t[q] += (uint64_t)ar[x] * bw[q - x + L - 1];
  }

  // rounds: column i belongs to rank i / C, slot i % C. Inside a range
  // the owner adds m_i p_1 + c_i to its column i + 1 at once and m_i goes
  // round the team in a 32-bit shuffle, added (times p) into every other
  // column one round later (lag); at a range's end (c_i << 16) | m_i goes
  // in one 64-bit shuffle and every rank adds it at once. Slot q sees
  // p_(c0 + q - i) in round i at pw[q - i + L - 1].
  uint32_t pw[W - 1];
#pragma unroll
  for (int z = 0; z < W - 1; ++z) pw[z] = pz[z];
  const uint32_t p0 = M.p[0], p1 = M.p[1];
  uint32_t lag = 0;                       // m of round i - 1, in flight
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const bool owner = rank == i / C;
    const uint64_t ti = t[i % C];        // meaningful on the owner only
    uint32_t m = ((uint32_t)ti * M.n0) & MASK16;
    uint64_t c = (ti + (uint64_t)m * p0) >> 16;
    if (i > 0 && (i - 1) % C != C - 1) {  // round i - 1's m, lagged
#pragma unroll
      for (int q = 0; q < C; ++q) {
        // the owner of round i - 1 took its column i (slot i % C) at once
        const uint32_t mq = (q == i % C && owner) ? 0u : lag;
        t[q] += (uint64_t)mq * pw[q - i + L];
      }
    }
    if (i % C != C - 1) {
      // m p_1 joins column i + 1 beside the carry's chain
      const uint64_t u = t[i % C + 1] + (uint64_t)m * p1;
      t[i % C + 1] = owner ? u + c : t[i % C + 1];
      lag = __shfl_sync(0xFFFFFFFFu, m, lead + i / C);
    } else {
      const uint64_t word = shfl64((c << 16) | m, lead + i / C);
      m = (uint32_t)word & MASK16;
      c = word >> 16;
#pragma unroll
      for (int q = 0; q < C; ++q) t[q] += (uint64_t)m * pw[q - i + L - 1];
      if (rank == i / C + 1) t[0] += c;
    }
  }
  if ((L - 1) % C != C - 1) {             // round L - 1's m, lagged
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const uint32_t mq = (q == L % C && rank == (L - 1) / C) ? 0u : lag;
      t[q] += (uint64_t)mq * pw[q];
    }
  }

  // high half: columns L .. 2L - 1 to 16-bit digits. Each rank normalizes
  // its own (carry out < 2^36); NP passes move each rank's carry into the
  // next rank's digits, until every carry is 0 or 1 (one pass when a rank
  // holds 3 or more digits); then a carry-lookahead over the team's
  // ballots of generate (carry 1) and propagate (digits all 0xFFFF) gives
  // each rank its carry in. The carry out of column 2L - 1 is dropped.
  constexpr int NP = C >= 3 ? 1 : (C == 2 ? 2 : 3);
  uint64_t carry = 0;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if (c0 + q >= L && c0 + q < 2 * L) {
      const uint64_t v = t[q] + carry;
      t[q] = v & MASK16;
      carry = v >> 16;
    }
  }
#pragma unroll
  for (int pass = 0; pass < NP; ++pass) {
    const uint32_t lo = __shfl_up_sync(0xFFFFFFFFu, (uint32_t)carry, 1, T);
    const uint32_t hi =
        __shfl_up_sync(0xFFFFFFFFu, (uint32_t)(carry >> 32), 1, T);
    carry = rank == 0 ? 0 : ((uint64_t)hi << 32) | lo;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (c0 + q >= L && c0 + q < 2 * L) {
        const uint64_t v = t[q] + carry;
        t[q] = v & MASK16;
        carry = v >> 16;
      }
    }
  }
  bool ones = true;
#pragma unroll
  for (int q = 0; q < C; ++q)
    if (c0 + q >= L && c0 + q < 2 * L) ones = ones && t[q] == MASK16;
  const unsigned team = T == 32 ? 0xFFFFFFFFu : (1u << (T % 32)) - 1u;
  const unsigned g = (__ballot_sync(0xFFFFFFFFu, carry != 0) >> lead) & team;
  const unsigned pr = (__ballot_sync(0xFFFFFFFFu, ones) >> lead) & team;
  const unsigned x = g | pr;
  uint32_t cin = (((x + g) ^ x ^ g) >> rank) & 1u;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if (c0 + q >= L && c0 + q < 2 * L) {
      const uint32_t v = (uint32_t)t[q] + cin;
      t[q] = v & MASK16;
      cin = v >> 16;
    }
  }
}

// Host side: constants arrive as one uint32 array from the Python wrapper
// (kzg_tpu_torch/ops/cuda.py builds it): p[L], one[L], n0, n1; p32 packs
// p's limbs in pairs.
constexpr int MOD_WORDS = 2 * L + 2;

inline Mod mod_from_host(const uint32_t* h) {
  Mod M;
  for (int k = 0; k < L; ++k) M.p[k] = h[k];
  for (int k = 0; k < L; ++k) M.one[k] = h[L + k];
  M.n0 = h[2 * L];
  M.n1 = h[2 * L + 1];
  for (int j = 0; j < D32 - 1; ++j) M.p32[j] = h[2 * j] | h[2 * j + 1] << 16;
  return M;
}

// Error code the C entry points return for a limb count they were not
// instantiated for (CUDA's own codes are below 1000).
constexpr int BAD_LIMBS = 1001;

}  // namespace kzg
