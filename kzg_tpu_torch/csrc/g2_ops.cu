// K4: G2 complete point add (with an optional per-lane reset mask) and
// K5: a chain of `times` G2 complete doublings, BN254's twist (a = 0).
//
// Replace the G2 instances of the JAX package's composite Pallas kernels
// (kzg_tpu/ops/fuse.py pl.pallas_call through fuse_composite /
// fuse_pointwise):
//   K4 <- T2 kzg_tpu/groups/ec.py Curve.add_f, T4 the chunked bucket step
//         kzg_tpu/ops/msm.py:268-274 select(s, p, add(c, p)) (the reset
//         mask), T6/T7 the weighted-reduction adds msm.py:511-514,535-536 —
//         on verify's G2 MSM and setup's G2 comb;
//   K5 <- T3 kzg_tpu/groups/ec.py Curve.dbl_f(times), run by
//         MSMEngine.precompute_shifted (times = 8) over the G2 setup points
//         on the first verify.
//
// Bound on the card: an add reads 6 and writes 3 Fp2 coordinates (9 x 2 x
// 17 int64 limbs, 2448 bytes per lane) and does 14 Fp2 products (42 base
// products) plus 6 base products to re-reduce its outputs; a doubling
// does 9 Fp2 products (27 base). At main-path widths (tens to a few
// thousand lanes) the kernels are latency-bound, not byte- or
// multiply-bound. Design (fp2.cuh): one thread per lane; the base product
// is one __noinline__ function whose operands live in the thread's local
// memory (L1-cached), so registers stay bounded and nvcc compiles one
// unrolled base product; the constants sit in shared memory. Point
// formulas: g2.cuh, shared with K6.
#include "g2.cuh"

namespace kzg {

__global__ void __launch_bounds__(128)
g2_add_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
              const int64_t* __restrict__ pz, const int64_t* __restrict__ qx,
              const int64_t* __restrict__ qy, const int64_t* __restrict__ qz,
              const uint8_t* __restrict__ reset, int64_t* __restrict__ out,
              int64_t lanes, G2Consts Cp) {
  __shared__ G2Consts C;
  g2_consts_to_shared(C, Cp);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Pt2 Q, R;
  pt2_load(Q, qx, qy, qz, lanes, i);
  if (reset != nullptr && reset[i]) {
    pt2_fresh(R, Q, C.F.M);             // segment start: restart at Q
  } else {
    Pt2 P;
    pt2_load(P, px, py, pz, lanes, i);
    g2_add(R, P, Q, C);
  }
  pt2_store(out, R, lanes, i);
}

__global__ void __launch_bounds__(128)
g2_dbl_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
              const int64_t* __restrict__ pz, int64_t* __restrict__ out,
              int64_t lanes, int times, G2Consts Cp) {
  __shared__ G2Consts C;
  g2_consts_to_shared(C, Cp);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Pt2 P;
  pt2_load(P, px, py, pz, lanes, i);
  for (int t = 0; t < times; ++t) g2_dbl(P, C);
  Pt2 R;
  pt2_fresh(R, P, C.F.M);
  pt2_store(out, R, lanes, i);
}

}  // namespace kzg

// P, Q coordinates: int64[2, n_limbs, lanes] contiguous on the card; reset:
// uint8[lanes] or null; out: int64[3, 2, n_limbs, lanes]. out = reset ? Q :
// P + Q per lane. Returns cudaGetLastError() after the launch.
extern "C" int kzg_g2_add(const int64_t* px, const int64_t* py,
                          const int64_t* pz, const int64_t* qx,
                          const int64_t* qy, const int64_t* qz,
                          const uint8_t* reset, int64_t* out, int64_t lanes,
                          const uint32_t* consts, int n_limbs, void* stream) {
  if (n_limbs != kzg::L) return kzg::BAD_LIMBS;
  const kzg::G2Consts C = kzg::g2_from_host(consts);
  const int threads = 128;
  const int64_t blocks = (lanes + threads - 1) / threads;
  kzg::g2_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      px, py, pz, qx, qy, qz, reset, out, lanes, C);
  return (int)cudaGetLastError();
}

// out = 2^times P per lane.
extern "C" int kzg_g2_dbl(const int64_t* px, const int64_t* py,
                          const int64_t* pz, int64_t* out, int64_t lanes,
                          int times, const uint32_t* consts, int n_limbs,
                          void* stream) {
  if (n_limbs != kzg::L) return kzg::BAD_LIMBS;
  const kzg::G2Consts C = kzg::g2_from_host(consts);
  const int threads = 128;
  const int64_t blocks = (lanes + threads - 1) / threads;
  kzg::g2_dbl_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      px, py, pz, out, lanes, times, C);
  return (int)cudaGetLastError();
}
