// K6: the merge-strategy combine of the bucket accumulation, one launch per
// merge level, for G1 and for G2 (one source, templated on the group).
//
// Replaces T5, kzg_tpu/ops/msm.py:187-203 MSMEngine._bucket_sums_merge
// `combine`, traced into one Pallas kernel per level by fuse_composite
// (kzg_tpu/ops/fuse.py pl.pallas_call). Per lane of the level's batch
// (W windows x m/2 node pairs):
//   mid  = aR + bL                       (complete add)
//   newL = (asing & fuse) ? mid : aL
//   newR = (bsing & fuse) ? mid : bR
// mid is re-reduced as the add kernels' outputs are (exact 16-bit limbs,
// < 1.1 p per component); a lane that keeps aL or bR copies its limbs
// unchanged, as the plain select does.
//
// Bound on the card: a lane reads 4 points and 3 mask bytes and writes 3
// points (7 x 3 coordinates), and does one complete add. At the first
// level of a 4097-point MSM (32 x 4096 lanes) both instances are far from
// either bound, the G2 one held back by its local-memory operands
// (fp2.cuh). The design keeps one lane in one thread over the one-thread
// point functions of g1.cuh and g2.cuh, so the combine costs one launch
// per level instead of an add launch plus two select passes. The
// selected outputs are copied back from mid's output slot rather than
// kept live in registers: with mid live across both selections ptxas took
// minutes on this file, without it seconds.
#include "g1.cuh"
#include "g2.cuh"

namespace kzg {

// Coordinate pointers of the four input points aL, aR, bL, bR (x, y, z
// each), passed by value as a kernel parameter.
struct Pts4 {
  const int64_t* p[12];
};

struct G1Group {
  using Point = Pt;
  using Consts = G1Consts;
  static constexpr int WORDS = L;               // int64 words per lane
  static __device__ __forceinline__ void load(Point& P,
                                              const int64_t* const* c,
                                              int64_t lanes, int64_t i) {
    pt_load(P, c[0], c[1], c[2], lanes, i);
  }
  static __device__ __forceinline__ void store(int64_t* out, const Point& P,
                                               int64_t lanes, int64_t i) {
    pt_store(out, P, lanes, i);
  }
  static __device__ __forceinline__ void add(Point& R, const Point& P,
                                             const Point& Q,
                                             const Consts& C) {
    g1_add(R, P, Q, C);
  }
};

struct G2Group {
  using Point = Pt2;
  using Consts = G2Consts;
  static constexpr int WORDS = 2 * L;
  static __device__ __forceinline__ void load(Point& P,
                                              const int64_t* const* c,
                                              int64_t lanes, int64_t i) {
    pt2_load(P, c[0], c[1], c[2], lanes, i);
  }
  static __device__ __forceinline__ void store(int64_t* out, const Point& P,
                                               int64_t lanes, int64_t i) {
    pt2_store(out, P, lanes, i);
  }
  static __device__ __forceinline__ void add(Point& R, const Point& P,
                                             const Point& Q,
                                             const Consts& C) {
    g2_add(R, P, Q, C);
  }
};

// Copy one input point's limbs (x, y, z) into an output point slot.
template <class G>
__device__ __forceinline__ void copy_point(int64_t* out,
                                           const int64_t* const* c,
                                           int64_t lanes, int64_t i) {
  const int64_t coord = (int64_t)G::WORDS * lanes;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    for (int w = 0; w < G::WORDS; ++w)
      out[k * coord + w * lanes + i] = c[k][w * lanes + i];
}

// out: int64[3 (mid, newL, newR), 3 (x, y, z), WORDS, lanes]. newL and
// newR are copies of the lane's mid (read back from out) or of aL / bR, so
// mid need not stay live after its store.
template <class G>
__device__ __forceinline__ void combine_lane(
    const Pts4& in, const uint8_t* __restrict__ fuse,
    const uint8_t* __restrict__ asing, const uint8_t* __restrict__ bsing,
    int64_t* out, int64_t lanes, int64_t i, const typename G::Consts& C) {
  const int64_t coord = (int64_t)G::WORDS * lanes;
  {
    typename G::Point aR, bL, mid;
    G::load(aR, in.p + 3, lanes, i);
    G::load(bL, in.p + 6, lanes, i);
    G::add(mid, aR, bL, C);
    G::store(out, mid, lanes, i);
  }
  const int64_t* mid[3] = {out, out + coord, out + 2 * coord};
  const bool f = fuse[i] != 0;
  copy_point<G>(out + 3 * coord, (f && asing[i]) ? mid : in.p + 0, lanes, i);
  copy_point<G>(out + 6 * coord, (f && bsing[i]) ? mid : in.p + 9, lanes, i);
}

__global__ void __launch_bounds__(128)
merge_combine_g1_kernel(Pts4 in, const uint8_t* __restrict__ fuse,
                        const uint8_t* __restrict__ asing,
                        const uint8_t* __restrict__ bsing,
                        int64_t* out, int64_t lanes, G1Consts C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  combine_lane<G1Group>(in, fuse, asing, bsing, out, lanes, i, C);
}

__global__ void __launch_bounds__(128)
merge_combine_g2_kernel(Pts4 in, const uint8_t* __restrict__ fuse,
                        const uint8_t* __restrict__ asing,
                        const uint8_t* __restrict__ bsing,
                        int64_t* out, int64_t lanes, G2Consts Cp) {
  __shared__ G2Consts C;
  g2_consts_to_shared(C, Cp);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  combine_lane<G2Group>(in, fuse, asing, bsing, out, lanes, i, C);
}

inline Pts4 pts4_from_host(const uint64_t* ptrs) {
  Pts4 in;
  for (int k = 0; k < 12; ++k) in.p[k] = (const int64_t*)ptrs[k];
  return in;
}

}  // namespace kzg

// ptrs: host array of 12 device pointers, the x, y, z coordinates of aL,
// aR, bL, bR (each int64[n_limbs, lanes] for G1, int64[2, n_limbs, lanes]
// for G2, contiguous); fuse, asing, bsing: uint8[lanes]; out: int64[3, 3,
// (2,) n_limbs, lanes] = mid, newL, newR. Returns cudaGetLastError().
extern "C" int kzg_merge_combine_g1(const uint64_t* ptrs, const uint8_t* fuse,
                                    const uint8_t* asing,
                                    const uint8_t* bsing, int64_t* out,
                                    int64_t lanes, const uint32_t* consts,
                                    int n_limbs, void* stream) {
  if (n_limbs != kzg::L) return kzg::BAD_LIMBS;
  const kzg::G1Consts C = kzg::g1_from_host(consts);
  const int threads = 128;
  const int64_t blocks = (lanes + threads - 1) / threads;
  kzg::merge_combine_g1_kernel<<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
      kzg::pts4_from_host(ptrs), fuse, asing, bsing, out, lanes, C);
  return (int)cudaGetLastError();
}

extern "C" int kzg_merge_combine_g2(const uint64_t* ptrs, const uint8_t* fuse,
                                    const uint8_t* asing,
                                    const uint8_t* bsing, int64_t* out,
                                    int64_t lanes, const uint32_t* consts,
                                    int n_limbs, void* stream) {
  if (n_limbs != kzg::L) return kzg::BAD_LIMBS;
  const kzg::G2Consts C = kzg::g2_from_host(consts);
  const int threads = 128;
  const int64_t blocks = (lanes + threads - 1) / threads;
  kzg::merge_combine_g2_kernel<<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
      kzg::pts4_from_host(ptrs), fuse, asing, bsing, out, lanes, C);
  return (int)cudaGetLastError();
}
