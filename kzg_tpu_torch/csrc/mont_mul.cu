// K1: batched Montgomery multiply over a prime field of L limbs (L from
// -DKZG_L: 17 for BN254's Fp and Fr and BLS12-381's Fr, whose constants
// come from the host; 25 for BLS12-381's Fp; 11 for BN158's Fp and Fr).
//
// Replaces T1, the one Pallas kernel on the JAX package's default path:
// kzg_tpu/fields/mont.py Field.mul -> fuse_pointwise(Field._mul_impl)
// (kzg_tpu/ops/fuse.py pl.pallas_call), a float32-matmul Montgomery product
// tiled over 256-lane VMEM blocks. Here the product is integer-only, in two
// variants that kzg_tpu_torch/ops/cuda.py picks between by width
// (K1_TEAM_BELOW, per limb count); both give exact 16-bit limbs of
// (a b + m p) / R mod R, limb for limb Field._mul_plain's.
//
// Wide launches: one thread per lane, L x L 32x32->64-bit
// multiply-accumulates into 64-bit columns plus L base-2^16 reduction
// rounds in registers (mont.cuh). Per lane it moves 3 x L int64 limbs (408
// bytes at 17 limbs, 600 at 25, 264 at 11) and does 2 L^2 + L 16-bit
// multiply-accumulates, so at the int64 storage of the port's tensors it is
// bound by bytes, not by the integer multiply rate; it keeps every
// intermediate in registers and reads limb-major, so that a warp's loads of
// one limb are one contiguous 256-byte run.
//
// Narrow launches (the pairing's stacked Fp2 products, 108 lanes a pair;
// the NTT butterflies): a thread per lane leaves most of the card idle and
// a launch lasts as long as one thread's chain of 2 L^2 + L
// multiply-accumulates and L dependent rounds. There each lane gets a
// team of T threads of one warp (ops/k1_team.py states the layout and
// models it): the block stages its lanes' operands in shared memory with
// coalesced limb-major loads; then the team runs the split product of
// mont.cuh (rank r owns product columns [r C, r C + C), C = ceil(2 L / T);
// m_i and the carries go round the team in shuffles, the high half
// settles in a carry-lookahead over two ballots). Storing limbs as 32-bit
// words would halve the bytes of both; that is later work.
#include "mont.cuh"

namespace kzg {

__global__ void __launch_bounds__(128)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, int64_t lanes, Mod M) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Fe x, y, z;
  fe_load(x, a, lanes, i);
  fe_load(y, b, lanes, i);
  mont_mul(z, x, y, M);
  fe_store(out, z, lanes, i);
}

// as team.cuh's BAD_TABLE: a team table this build does not run
constexpr int BAD_K1_TABLE = 1002;
constexpr int K1_MAX_WARPS = 8;

// Shared memory (uint32 words), rows of a fixed stride S (one more than the
// most lanes a block can hold, so that a team's ranks, reading rows C
// apart at one lane, mostly hit distinct banks):
//   pz   L - 1 zeros, p_0 .. p_(L-1), zeros up to T C + L - 1 words:
//        pz[c0 + z] is p_(c0 - (L - 1) + z), zero outside [0, L), for
//        every rank's window (c0 = r C, z < L + C - 1);
//   sa   L rows: a_x of the block's lane j at x S + j;
//   sbz  the same rows for b: L - 1 zero rows, b_y at (y + L - 1) S + j,
//        zero rows up to T C + L - 1.
// Every read below is at a compile-time offset from one base. Every
// thread runs to the end (a team past `lanes` computes on zeros and
// stores nothing), so each shuffle and ballot names the whole warp. T
// divides 32.
template <int T>
struct K1Shape {
  static constexpr int C = SplitShape<T>::C;      // columns per rank
  static constexpr int K = (L + T - 1) / T;       // limbs a thread stages
  static constexpr int S = 32 / T * K1_MAX_WARPS + 1;
  static constexpr int PZ = T * C + L - 1;       // words of pz
  static constexpr int BZ = T * C + L - 1;        // rows of sbz
  static constexpr int WORDS = PZ + (L + BZ) * S;
};

template <int T>
__global__ void __launch_bounds__(32 * K1_MAX_WARPS)
mont_mul_team_kernel(const int64_t* __restrict__ a,
                     const int64_t* __restrict__ b,
                     int64_t* __restrict__ out, int64_t lanes, Mod M) {
  using Sh = K1Shape<T>;
  constexpr int C = Sh::C, K = Sh::K, S = Sh::S;
  constexpr int W = SplitShape<T>::W;        // a rank's window of b or p
  extern __shared__ uint32_t k1_sm[];
  uint32_t* pz = k1_sm;
  uint32_t* sa = pz + Sh::PZ;
  uint32_t* sbz = sa + L * S;
  const int lpb = (int)blockDim.x / T;
  const int64_t lane0 = (int64_t)blockIdx.x * lpb;
  {
    // thread tid stages lane tid % lpb, limbs tid / lpb + u T, and zeros
    // the same lane of the pad rows: all its loads are issued before the
    // first store, p's words and the pads are written under them
    const int k0 = (int)threadIdx.x / lpb;
    const int jj = (int)threadIdx.x - k0 * lpb;
    const int64_t i = lane0 + jj;
    uint32_t va[K], vb[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int k = k0 + u * T;
      const bool in = k < L && i < lanes;
      va[u] = in ? (uint32_t)a[(int64_t)k * lanes + i] : 0u;
      vb[u] = in ? (uint32_t)b[(int64_t)k * lanes + i] : 0u;
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < L; ++k) pz[L - 1 + k] = M.p[k];
    }
    for (int z = threadIdx.x; z < Sh::PZ - L; z += blockDim.x)
      pz[z < L - 1 ? z : z + L] = 0u;
#pragma unroll
    for (int u = 0; u < (Sh::BZ - L + T - 1) / T; ++u) {
      const int z = k0 + u * T;                  // pad row z of BZ - L
      if (z < Sh::BZ - L) sbz[(z < L - 1 ? z : z + L) * S + jj] = 0u;
    }
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int k = k0 + u * T;
      if (k < L) {
        sa[k * S + jj] = va[u];
        sbz[(k + L - 1) * S + jj] = vb[u];
      }
    }
  }
  __syncthreads();

  const int rank = (int)threadIdx.x & (T - 1);
  const int j = (int)threadIdx.x / T;              // the lane in the block
  const int lead = ((int)threadIdx.x & 31) - rank; // rank 0's warp lane
  const int c0 = rank * C;

  // the limbs go to registers: ar[x] = a_x, and bw[z] = b_(c0 - (L - 1)
  // + z), zero outside [0, L), the window under the rank's columns at
  // every x; then the split product (mont.cuh)
  uint64_t t[C];
  {
    uint32_t ar[L], bw[W - 1];
#pragma unroll
    for (int x = 0; x < L; ++x) ar[x] = sa[x * S + j];
    const uint32_t* bj = sbz + c0 * S + j;
#pragma unroll
    for (int z = 0; z < W - 1; ++z) bw[z] = bj[z * S];
    split_mul<T>(t, ar, bw, pz + c0, rank, lead, M);
  }
  const int64_t i = lane0 + j;
  if (i < lanes) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int k = c0 + q - L;
      if (k >= 0 && k < L) out[(int64_t)k * lanes + i] = (int64_t)t[q];
    }
  }
}

__global__ void empty_kernel() {}

template <int T>
static int launch_team(const int64_t* a, const int64_t* b, int64_t* out,
                       int64_t lanes, const Mod& M, int warps,
                       cudaStream_t stream) {
  const int lpb = (32 / T) * warps;
  const size_t smem = sizeof(uint32_t) * K1Shape<T>::WORDS;
  const int64_t blocks = (lanes + lpb - 1) / lpb;
  mont_mul_team_kernel<T><<<(unsigned)blocks, 32 * warps, smem, stream>>>(
      a, b, out, lanes, M);
  return (int)cudaGetLastError();
}

}  // namespace kzg

// a, b, out: int64[n_limbs, lanes] contiguous on the card; mod: p, R mod p,
// n0 as uint32 (host memory). Returns cudaGetLastError() after the launch.
extern "C" int kzg_mont_mul(const int64_t* a, const int64_t* b, int64_t* out,
                            int64_t lanes, const uint32_t* mod, int n_limbs,
                            void* stream) {
  if (n_limbs != kzg::L) return kzg::BAD_LIMBS;
  const kzg::Mod M = kzg::mod_from_host(mod);
  const int threads = 128;
  const int64_t blocks = (lanes + threads - 1) / threads;
  kzg::mont_mul_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(a, b, out, lanes, M);
  return (int)cudaGetLastError();
}

// The lane-team variant, the same arguments plus the team table (host
// memory, ops/k1_team.py table()): T, W, C, then each rank's (start, end)
// column range, which must be the even split this build's registers hold.
extern "C" int kzg_mont_mul_team(const int64_t* a, const int64_t* b,
                                 int64_t* out, int64_t lanes,
                                 const uint32_t* mod, int n_limbs,
                                 const uint32_t* tab, void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  const int T = (int)tab[0], W = (int)tab[1], C = (int)tab[2];
  if (W < 1 || W > K1_MAX_WARPS || T < 4 || T > 32 || (32 % T) != 0 ||
      C != (2 * L + T - 1) / T)
    return BAD_K1_TABLE;
  for (int r = 0; r < T; ++r) {
    const int s = r * C < 2 * L ? r * C : 2 * L;
    const int e = s + C < 2 * L ? s + C : 2 * L;
    if ((int)tab[3 + 2 * r] != s || (int)tab[4 + 2 * r] != e)
      return BAD_K1_TABLE;
  }
  const Mod M = mod_from_host(mod);
  cudaStream_t st = (cudaStream_t)stream;
  switch (T) {
    case 4: return launch_team<4>(a, b, out, lanes, M, W, st);
    case 8: return launch_team<8>(a, b, out, lanes, M, W, st);
    case 16: return launch_team<16>(a, b, out, lanes, M, W, st);
    case 32: return launch_team<32>(a, b, out, lanes, M, W, st);
    default: return BAD_K1_TABLE;
  }
}

// An empty kernel over `blocks` blocks of `threads` threads: the device
// time of a launch that does no work (chip_smoke.py's floor_ms).
extern "C" int kzg_k1_empty(int64_t blocks, int threads, void* stream) {
  kzg::empty_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
