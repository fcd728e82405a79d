// G1 point device functions of one thread per lane (BN254, a = 0), used by
// the G1 instance of K6 (msm_merge.cu), and the G1 constant block, whose
// modulus constants K2/K3 (g1_ops.cu, lane teams) read as well.
//
// The formula and lazy bounds are those of kzg_tpu/groups/ec.py Curve.add
// for BN254: 3b = 6 is a lazy small multiple, as Curve._mul_b3 ->
// Field.mul_const does for constants <= 14 (the wrapper refuses curves
// outside this branch). Inputs are coordinates as the field's lazy ops
// leave them (limbs < 2^20, values up to a few hundred p, e.g. a negated
// y); every Montgomery product then stays below 4 p. Every output
// coordinate of g1_add is re-reduced (fe_fresh): exact 16-bit limbs,
// value < 1.1 p.
#pragma once

#include "mont.cuh"

namespace kzg {

struct G1Consts {
  Mod M;
  uint32_t lift16[L];   // Field.lift_limbs(16): lazy sub slack of the add
  uint32_t b3;          // 3b, a small integer (<= 14)
};

struct Pt {
  Fe x, y, z;
};

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
// n0, lift16, 3b — 3 L + 2 uint32, followed by K2/K3's team block
// (team.cuh).
inline G1Consts g1_from_host(const uint32_t* h) {
  G1Consts C;
  C.M = mod_from_host(h);
  const uint32_t* r = h + 2 * L + 1;
  for (int k = 0; k < L; ++k) C.lift16[k] = r[k];
  C.b3 = r[L];
  return C;
}

}  // namespace kzg
