// G1 point device functions (BN254, a = 0), shared by K2/K3 (g1_ops.cu)
// and the G1 instance of K6 (msm_merge.cu).
//
// Formulas and lazy bounds are those of kzg_tpu/groups/ec.py Curve.add /
// Curve.dbl for BN254: 3b = 6 is a lazy small multiple, as
// Curve._mul_b3 -> Field.mul_const does for constants <= 14; 9b = 18 is a
// full Montgomery product by its Montgomery form, as Curve.dbl does for
// 9b > 15 (the wrapper refuses curves outside these branches). Inputs are
// coordinates as the field's lazy ops leave them (limbs < 2^20, values up
// to a few hundred p, e.g. a negated y); every Montgomery product then
// stays below 4 p. Every output coordinate of g1_add is re-reduced
// (fe_fresh): exact 16-bit limbs, value < 1.1 p.
#pragma once

#include "mont.cuh"

namespace kzg {

struct G1Consts {
  Mod M;
  uint32_t lift16[L];   // Field.lift_limbs(16): lazy sub slack of the add
  uint32_t lift32[L];   // Field.lift_limbs(32): lazy sub slack of the dbl
  uint32_t b3;          // 3b, a small integer (<= 14)
  uint32_t b9[L];       // Montgomery form of 9b
};

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ void fe_const(Fe& o, const uint32_t* c) {
#pragma unroll
  for (int k = 0; k < L; ++k) o.v[k] = c[k];
}

// RCB15 Alg 7 (a = 0), the dataflow of Curve.add.
__device__ __forceinline__ void g1_add(Pt& R, const Pt& P, const Pt& Q,
                                       const G1Consts& C) {
  const Mod& M = C.M;
  Fe t0, t1, t2, tA, tB, tC, u, w;
  mont_mul(t0, P.x, Q.x, M);
  mont_mul(t1, P.y, Q.y, M);
  mont_mul(t2, P.z, Q.z, M);
  fe_add(u, P.x, P.y);
  fe_add(w, Q.x, Q.y);
  mont_mul(tA, u, w, M);
  fe_add(u, P.y, P.z);
  fe_add(w, Q.y, Q.z);
  mont_mul(tB, u, w, M);
  fe_add(u, P.x, P.z);
  fe_add(w, Q.x, Q.z);
  mont_mul(tC, u, w, M);
  Fe t3, t4, t5;
  fe_add(u, t0, t1);
  fe_sub(t3, tA, u, C.lift16);          // X1Y2 + X2Y1
  fe_add(u, t1, t2);
  fe_sub(t4, tB, u, C.lift16);          // Y1Z2 + Y2Z1
  fe_add(u, t0, t2);
  fe_sub(t5, tC, u, C.lift16);          // X1Z2 + X2Z1
  Fe Ft, Zt, Mm, G, t03;
  fe_small(Ft, t2, C.b3);               // 3b Z1Z2
  fe_add(Zt, t1, Ft);                   // Y1Y2 + 3bZ1Z2
  fe_sub(Mm, t1, Ft, C.lift16);         // Y1Y2 - 3bZ1Z2
  fe_small(G, t5, C.b3);                // 3b (X1Z2 + X2Z1)
  fe_small(t03, t0, 3);                 // 3 X1X2
  Fe a, b;
  mont_mul(a, t3, Mm, M);
  mont_mul(b, t4, G, M);
  fe_sub(u, a, b, C.lift16);
  fe_fresh(R.x, u, M);
  mont_mul(a, Mm, Zt, M);
  mont_mul(b, t03, G, M);
  fe_add(u, a, b);
  fe_fresh(R.y, u, M);
  mont_mul(a, t4, Zt, M);
  mont_mul(b, t3, t03, M);
  fe_add(u, a, b);
  fe_fresh(R.z, u, M);
}

// RCB15 Alg 9 (a = 0), the dataflow of Curve.dbl; outputs lazy (X, Y
// < 2.2 p, limbs <= 2^17; Z fresh) — valid inputs of the next doubling.
__device__ __forceinline__ void g1_dbl(Pt& P, const G1Consts& C) {
  const Mod& M = C.M;
  Fe t0, t1, zz, xy, e8, t2, Y3t, X3, Z3, t29, c, Ya, Xa;
  mont_mul(t0, P.y, P.y, M);
  mont_mul(t1, P.y, P.z, M);
  mont_mul(zz, P.z, P.z, M);
  mont_mul(xy, P.x, P.y, M);
  fe_small(e8, t0, 8);                  // 8 Y^2
  fe_small(t2, zz, C.b3);               // 3b Z^2
  fe_add(Y3t, t0, t2);                  // Y^2 + 3b Z^2
  mont_mul(X3, t2, e8, M);
  mont_mul(Z3, t1, e8, M);
  fe_const(c, C.b9);
  mont_mul(t29, zz, c, M);              // 9b Z^2
  fe_sub(t0, t0, t29, C.lift32);        // Y^2 - 9b Z^2
  mont_mul(Ya, t0, Y3t, M);
  mont_mul(Xa, t0, xy, M);
  fe_add(P.y, Ya, X3);
  fe_small(P.x, Xa, 2);
  P.z = Z3;
}

__device__ __forceinline__ void pt_fresh(Pt& R, const Pt& P, const Mod& M) {
  fe_fresh(R.x, P.x, M);
  fe_fresh(R.y, P.y, M);
  fe_fresh(R.z, P.z, M);
}

// A G1 point batch is three int64[L, lanes] coordinate arrays.
__device__ __forceinline__ void pt_load(Pt& P, const int64_t* x,
                                        const int64_t* y, const int64_t* z,
                                        int64_t lanes, int64_t i) {
  fe_load(P.x, x, lanes, i);
  fe_load(P.y, y, lanes, i);
  fe_load(P.z, z, lanes, i);
}

// out: int64[3, L, lanes].
__device__ __forceinline__ void pt_store(int64_t* out, const Pt& P,
                                         int64_t lanes, int64_t i) {
  const int64_t coord = (int64_t)L * lanes;
  fe_store(out, P.x, lanes, i);
  fe_store(out + coord, P.y, lanes, i);
  fe_store(out + 2 * coord, P.z, lanes, i);
}

// Host array layout (kzg_tpu_torch/ops/cuda.py _g1_consts): p, R mod p,
// n0, lift16, lift32, 3b, 9b — 5 L + 2 uint32.
inline G1Consts g1_from_host(const uint32_t* h) {
  G1Consts C;
  C.M = mod_from_host(h);
  const uint32_t* r = h + 2 * L + 1;
  for (int k = 0; k < L; ++k) C.lift16[k] = r[k];
  for (int k = 0; k < L; ++k) C.lift32[k] = r[L + k];
  C.b3 = r[2 * L];
  for (int k = 0; k < L; ++k) C.b9[k] = r[2 * L + 1 + k];
  return C;
}

}  // namespace kzg
