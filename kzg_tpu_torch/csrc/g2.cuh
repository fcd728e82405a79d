// G2 point device functions (BN254's twist over Fp2, a = 0) of one
// thread per lane, used by the G2 instance of K6 (msm_merge.cu), and the G2
// constant block, whose modulus constants K4/K5 (g2_ops.cu) read as well.
//
// The dataflow is that of kzg_tpu_torch/groups/ec.py Curve._add_plain
// over Fp2 (kzg_tpu/groups/ec.py Curve.add):
//   * 3b' is a full Fp2 constant: Curve._mul_b3 is a full Fp2 product by
//     the Montgomery form of the twist's 3b', here too;
//   * every subtraction is exact (Fp2.sub, lazy=False) with the slack the
//     plain version names, k = 16.
// Inputs are coordinates as the Fp2 ops leave them (components up to a
// few tens of p, exact or lazily added 16-bit limbs). Every output
// coordinate of g2_add is re-reduced: exact 16-bit limbs, each component
// < 1.1 p — tighter than the plain version's outputs, which the pairing
// tower's exact-sub budgets (fields/quadratic.py) accept all the more.
#pragma once

#include "fp2.cuh"

namespace kzg {

struct G2Consts {
  Fp2Mod F;
  uint32_t kp16[L];     // exact 16-bit limbs of 16 p: the add's sub slack
  Fe2 b3;               // Montgomery form of the twist's 3b'
};

struct Pt2 {
  Fe2 x, y, z;
};

// RCB15 Alg 7 (a = 0) over Fp2, the dataflow of Curve._add_plain.
__device__ __forceinline__ void g2_add(Pt2& R, const Pt2& P, const Pt2& Q,
                                       const G2Consts& C) {
  const Fp2Mod& F = C.F;
  Fe2 t0, t1, t2, tA, tB, tC, u, w;
  fp2_mul(t0, P.x, Q.x, F);
  fp2_mul(t1, P.y, Q.y, F);
  fp2_mul(t2, P.z, Q.z, F);
  fp2_add(u, P.x, P.y);
  fp2_add(w, Q.x, Q.y);
  fp2_mul(tA, u, w, F);
  fp2_add(u, P.y, P.z);
  fp2_add(w, Q.y, Q.z);
  fp2_mul(tB, u, w, F);
  fp2_add(u, P.x, P.z);
  fp2_add(w, Q.x, Q.z);
  fp2_mul(tC, u, w, F);
  Fe2 t3, t4, t5;
  fp2_add(u, t0, t1);
  fp2_sub(t3, tA, u, C.kp16);           // X1Y2 + X2Y1
  fp2_add(u, t1, t2);
  fp2_sub(t4, tB, u, C.kp16);           // Y1Z2 + Y2Z1
  fp2_add(u, t0, t2);
  fp2_sub(t5, tC, u, C.kp16);           // X1Z2 + X2Z1
  Fe2 Ft, Zt, Mm, G, t03;
  fp2_mul(Ft, t2, C.b3, F);             // 3b' Z1Z2
  fp2_add(Zt, t1, Ft);                  // Y1Y2 + 3b'Z1Z2
  fp2_sub(Mm, t1, Ft, C.kp16);          // Y1Y2 - 3b'Z1Z2
  fp2_mul(G, t5, C.b3, F);              // 3b' (X1Z2 + X2Z1)
  fp2_small(t03, t0, 3);                // 3 X1X2
  Fe2 a, b;
  fp2_mul(a, t3, Mm, F);
  fp2_mul(b, t4, G, F);
  fp2_sub(u, a, b, C.kp16);
  fp2_fresh(R.x, u, F.M);
  fp2_mul(a, Mm, Zt, F);
  fp2_mul(b, t03, G, F);
  fp2_add(u, a, b);
  fp2_fresh(R.y, u, F.M);
  fp2_mul(a, t4, Zt, F);
  fp2_mul(b, t3, t03, F);
  fp2_add(u, a, b);
  fp2_fresh(R.z, u, F.M);
}

// A G2 point batch is three int64[2, L, lanes] coordinate arrays.
__device__ __forceinline__ void pt2_load(Pt2& P, const int64_t* x,
                                         const int64_t* y, const int64_t* z,
                                         int64_t lanes, int64_t i) {
  fe2_load(P.x, x, lanes, i);
  fe2_load(P.y, y, lanes, i);
  fe2_load(P.z, z, lanes, i);
}

// out: int64[3, 2, L, lanes].
__device__ __forceinline__ void pt2_store(int64_t* out, const Pt2& P,
                                          int64_t lanes, int64_t i) {
  const int64_t coord = 2 * (int64_t)L * lanes;
  fe2_store(out, P.x, lanes, i);
  fe2_store(out + coord, P.y, lanes, i);
  fe2_store(out + 2 * coord, P.z, lanes, i);
}

// The constants arrive as a kernel parameter; one thread copies them into
// the block's shared memory, where the __noinline__ products can address
// them (a kernel parameter passed by address would be copied per thread).
__device__ __forceinline__ void g2_consts_to_shared(G2Consts& dst,
                                                    const G2Consts& src) {
  if (threadIdx.x == 0) dst = src;
  __syncthreads();
}

// Host array layout (kzg_tpu_torch/ops/cuda.py _g2_consts): p, R mod p, n0,
// 2p, 4p, 16p (exact 16-bit limbs), 3b' c0, 3b' c1 (Montgomery) —
// 7 L + 1 uint32, followed by K4/K5's team block (team.cuh).
inline G2Consts g2_from_host(const uint32_t* h) {
  G2Consts C;
  C.F.M = mod_from_host(h);
  const uint32_t* r = h + 2 * L + 1;
  for (int k = 0; k < L; ++k) C.F.kp2[k] = r[k];
  for (int k = 0; k < L; ++k) C.F.kp4[k] = r[L + k];
  for (int k = 0; k < L; ++k) C.kp16[k] = r[2 * L + k];
  for (int k = 0; k < L; ++k) C.b3.c0.v[k] = r[3 * L + k];
  for (int k = 0; k < L; ++k) C.b3.c1.v[k] = r[4 * L + k];
  return C;
}

}  // namespace kzg
