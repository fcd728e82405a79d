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
// multiply launches. The point formulas live in g1.cuh, shared with K6.
#include "g1.cuh"

namespace kzg {

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
    pt_fresh(R, Q, C.M);                // segment start: restart at Q
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
  pt_fresh(R, P, C.M);
  pt_store(out, R, lanes, i);
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
