// K2: G1 complete point add (with an optional per-lane reset mask) and
// K3: a chain of `times` G1 complete doublings, BN254 (a = 0).
//
// Replace the JAX package's composite Pallas kernels, each a whole group
// operation traced into one VMEM-resident fuse_pointwise kernel
// (kzg_tpu/ops/fuse.py pl.pallas_call; opt-in there because of Mosaic
// compile latency):
//   K2 <- T2 kzg_tpu/groups/ec.py Curve.add_f (RCB15 Alg 7), T4 the chunked
//         bucket step kzg_tpu/ops/msm.py MSMEngine._bucket_sums_chunked
//         `step` = select(s, p, add(c, p)) (the reset mask), T6/T7 the
//         weighted-reduction adds of MSMEngine._weighted_chunked;
//   K3 <- T3 kzg_tpu/groups/ec.py Curve.dbl_f(times) (RCB15 Alg 9), run by
//         MSMEngine.precompute_shifted with times = 8.
//
// Bound on the card: an add reads 6 and writes 3 coordinates (9 x 17 int64
// limbs, 1224 bytes per lane) and does 13 Montgomery products plus 3 to
// re-reduce its outputs (~9,500 16-bit multiply-accumulates); a doubling
// chain reads 3 and writes 3 coordinates for 8 products per doubling. At
// main-path widths (about a thousand lanes per bucket step) both are bound
// by latency and launch count rather than by bytes or multiplies. The
// design keeps a whole point operation in one thread's registers, so no
// intermediate coordinate touches memory and one launch replaces a dozen
// multiply launches.
//
// Formulas and lazy bounds are those of kzg_tpu/groups/ec.py Curve.add /
// Curve.dbl for BN254: 3b = 6 is a lazy small multiple, as
// Curve._mul_b3 -> Field.mul_const does for constants <= 14; 9b = 18 is a
// full Montgomery product by its Montgomery form, as Curve.dbl does for
// 9b > 15 (the wrapper refuses curves outside these branches). Inputs are
// coordinates as the field's lazy ops leave them (limbs < 2^20, values up
// to a few hundred p, e.g. a negated y); every Montgomery product then
// stays below 4 p. Every output coordinate is re-reduced (fe_fresh): exact
// 16-bit limbs, value < 1.1 p.
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

__device__ __forceinline__ void pt_load(Pt& P, const int64_t* x,
                                        const int64_t* y, const int64_t* z,
                                        int64_t lanes, int64_t i) {
  fe_load(P.x, x, lanes, i);
  fe_load(P.y, y, lanes, i);
  fe_load(P.z, z, lanes, i);
}

__device__ __forceinline__ void pt_store(int64_t* out, const Pt& P,
                                         int64_t lanes, int64_t i) {
  const int64_t coord = (int64_t)L * lanes;
  fe_store(out, P.x, lanes, i);
  fe_store(out + coord, P.y, lanes, i);
  fe_store(out + 2 * coord, P.z, lanes, i);
}

__global__ void __launch_bounds__(128)
g1_add_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
              const int64_t* __restrict__ pz, const int64_t* __restrict__ qx,
              const int64_t* __restrict__ qy, const int64_t* __restrict__ qz,
              const uint8_t* __restrict__ reset, int64_t* __restrict__ out,
              int64_t lanes, G1Consts C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Pt Q, R;
  pt_load(Q, qx, qy, qz, lanes, i);
  if (reset != nullptr && reset[i]) {
    // segment start: the running sum restarts at Q
    fe_fresh(R.x, Q.x, C.M);
    fe_fresh(R.y, Q.y, C.M);
    fe_fresh(R.z, Q.z, C.M);
  } else {
    Pt P;
    pt_load(P, px, py, pz, lanes, i);
    g1_add(R, P, Q, C);
  }
  pt_store(out, R, lanes, i);
}

__global__ void __launch_bounds__(128)
g1_dbl_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
              const int64_t* __restrict__ pz, int64_t* __restrict__ out,
              int64_t lanes, int times, G1Consts C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Pt P;
  pt_load(P, px, py, pz, lanes, i);
  for (int t = 0; t < times; ++t) g1_dbl(P, C);
  Pt R;
  fe_fresh(R.x, P.x, C.M);
  fe_fresh(R.y, P.y, C.M);
  fe_fresh(R.z, P.z, C.M);
  pt_store(out, R, lanes, i);
}

// Host array layout (kzg_tpu_torch/ops/cuda.py): p, R mod p, n0, lift16,
// lift32, 3b, 9b — 5 L + 2 uint32.
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

// P, Q coordinates: int64[n_limbs, lanes] contiguous on the card; reset:
// uint8[lanes] or null; out: int64[3, n_limbs, lanes]. out = reset ? Q :
// P + Q per lane. Returns cudaGetLastError() after the launch.
extern "C" int kzg_g1_add(const int64_t* px, const int64_t* py,
                          const int64_t* pz, const int64_t* qx,
                          const int64_t* qy, const int64_t* qz,
                          const uint8_t* reset, int64_t* out, int64_t lanes,
                          const uint32_t* consts, int n_limbs, void* stream) {
  if (n_limbs != kzg::L) return kzg::BAD_LIMBS;
  const kzg::G1Consts C = kzg::g1_from_host(consts);
  const int threads = 128;
  const int64_t blocks = (lanes + threads - 1) / threads;
  kzg::g1_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      px, py, pz, qx, qy, qz, reset, out, lanes, C);
  return (int)cudaGetLastError();
}

// out = 2^times P per lane.
extern "C" int kzg_g1_dbl(const int64_t* px, const int64_t* py,
                          const int64_t* pz, int64_t* out, int64_t lanes,
                          int times, const uint32_t* consts, int n_limbs,
                          void* stream) {
  if (n_limbs != kzg::L) return kzg::BAD_LIMBS;
  const kzg::G1Consts C = kzg::g1_from_host(consts);
  const int threads = 128;
  const int64_t blocks = (lanes + threads - 1) / threads;
  kzg::g1_dbl_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      px, py, pz, out, lanes, times, C);
  return (int)cudaGetLastError();
}
