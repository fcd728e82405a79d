// The lane-team executor of K2/K3 (G1 complete add and doubling chain,
// g1_ops.cu), K4/K5 (G2, g2_ops.cu) and K6 (the merge combine of either
// group, msm_merge.cu): each lane of a batch is owned by a team of T
// threads inside one warp, and the team runs the lane's formula as a
// schedule of levels, read from a table that kzg_tpu_torch/ops/team.py
// builds (its docstring defines the instructions and the table's words).
// Nothing here knows the group: a kernel loads its point's base elements
// into the first slots, runs schedules and stores the output slots that
// the table names. K6 runs the add's schedule, in a layout of its own
// from the header's WIDE lanes up and in the add's below.
//
// The team block (the host array behind K1's 2 L + 1 modulus words in
// each group's constants, team.py block()): 8 constant rows of L words
// (the constant slots R mod p and two group constants, then the exact
// subtractions' five slacks m p), then the table. Shared memory of a
// kernel's block (dynamic, uint32 words):
//   [0, 8L)        the constant rows;
//   [8L, ...)      the lanes' slots, slot s limb k of lane j (in the block)
//                  at 8L + (s L + k) lpb + j, lpb = lanes per block: the
//                  teams of a warp touch neighbouring words.
// The table sits in constant memory (uploaded by the C entry points when it
// changes; each module has its own image): in a level every team of a warp
// reads the same instruction words for the same rank, so a warp's fetch is
// at most T distinct words. The add, doubling and merge kernels of a group
// have their own team layouts (header words 0-2, 3-5 and 6-8) and share
// one image, so alternating launches upload nothing.
//
// One instruction runs in one thread: its operands (sums of up to four
// slots, times a small scale) are loaded from shared memory into
// registers, and a product is the inlined mont_mul of mont.cuh (the form
// K1 runs near its byte bound), so each kernel holds one unrolled L x L
// product. Shared memory and the constant rows grow with L (25 / 17 of
// BN254's at BLS12-381's 25 limbs, 11 / 17 at BN158's 11); the table does
// not depend on L. After
// each level the team meets at __syncwarp(team mask); a team never waits
// on threads outside it, so a team past the batch's end or a warp's spare
// threads may leave early.
#pragma once

#include <cstring>

#include "mont.cuh"

namespace kzg {

constexpr int TEAM_WORDS = 768;          // capacity of the schedule table
constexpr int TEAM_HDR = 38;             // its header (team.py HDR)
constexpr int TEAM_N_OUT = 6;            // output slot room per list
// header words after the kinds' layouts (team.py WIDE ... OUTS)
enum { TAB_WIDE = 9, TAB_LEVELS = 10, TAB_INSTRS = 11, TAB_RANGES = 12,
       TAB_OUTS = 20 };
constexpr uint32_t CONST_SLOT = 240;     // slot ids >= this are constants
constexpr int TEAM_CONST_WORDS = 8 * L;  // constant slots + slacks
constexpr int BAD_TABLE = 1002;
constexpr int CONST_WORDS = 2 * L + 1;   // K1's words before the team block
enum { T_MUL = 0, T_LAZY = 1, T_EXACT = 2 };
enum { S_ADD = 0, S_RESET = 1, S_DBL = 2, S_FRESH = 3 };
enum { O_ADD = 0, O_RESET = 1, O_FRESH = 2 };
enum { K_ADD = 0, K_DBL = 1, K_MERGE = 2, TEAM_KINDS = 3 };  // words 3 k

struct TeamImage {
  uint32_t cst[TEAM_CONST_WORDS];
  uint32_t tab[TEAM_WORDS];
};

__constant__ TeamImage c_team;

extern __shared__ uint32_t team_sm[];

struct TeamLane {
  int team, rank, lpb, j;
  unsigned mask;
  int64_t i;                             // the lane in the batch
};

// Copy the constant rows to shared memory and place this thread for a
// kernel of kind `kind`; false for a thread without a lane (a warp's spare
// threads, a team past the end). Every thread of the block calls it before
// any leaves.
__device__ __forceinline__ bool team_setup(TeamLane& t, int64_t lanes,
                                           int kind) {
  for (int w = threadIdx.x; w < TEAM_CONST_WORDS; w += blockDim.x)
    team_sm[w] = c_team.cst[w];
  __syncthreads();
  t.team = (int)c_team.tab[3 * kind];
  const int per_warp = 32 / t.team;
  const int wl = threadIdx.x & 31;
  const int tw = wl / t.team;
  if (tw >= per_warp) return false;
  t.rank = wl - tw * t.team;
  t.lpb = per_warp * (int)(blockDim.x >> 5);
  t.j = (int)(threadIdx.x >> 5) * per_warp + tw;
  t.i = (int64_t)blockIdx.x * t.lpb + t.j;
  t.mask = (t.team == 32 ? 0xFFFFFFFFu : ((1u << t.team) - 1u))
           << (tw * t.team);
  return t.i < lanes;
}

__device__ __forceinline__ int slot_word(const TeamLane& t, uint32_t s,
                                         int k) {
  return TEAM_CONST_WORDS + ((int)s * L + k) * t.lpb + t.j;
}

// x = scale * (sum of n slots packed 8 bits each in `slots`), limbwise.
__device__ __forceinline__ void team_sum(Fe& x, uint32_t n, uint32_t slots,
                                         uint32_t scale, const TeamLane& t) {
#pragma unroll
  for (int k = 0; k < L; ++k) x.v[k] = 0;
  for (uint32_t q = 0; q < n; ++q) {
    const uint32_t s = (slots >> (8 * q)) & 0xFFu;
    int base, stride;
    if (s >= CONST_SLOT) {
      base = (int)(s - CONST_SLOT) * L;
      stride = 1;
    } else {
      base = slot_word(t, s, 0);
      stride = t.lpb;
    }
#pragma unroll
    for (int k = 0; k < L; ++k) x.v[k] += team_sm[base + k * stride];
  }
#pragma unroll
  for (int k = 0; k < L; ++k) x.v[k] *= scale;
}

// One instruction: MUL, LAZY or EXACT (team.py), result into its slot.
__device__ __forceinline__ void team_exec(int at, const TeamLane& t,
                                          const Mod& M) {
  const uint32_t w0 = c_team.tab[at];
  const uint32_t kind = w0 & 3u;
  Fe a, o;
  team_sum(a, (w0 >> 22) & 7u, c_team.tab[at + 1], (w0 >> 10) & 63u, t);
  if (kind == T_LAZY) {
    o = a;
  } else {
    Fe b;
    team_sum(b, (w0 >> 25) & 7u, c_team.tab[at + 2], (w0 >> 16) & 63u, t);
    if (kind == T_MUL) {
      mont_mul(o, a, b, M);
    } else {
      uint32_t kp[L];
      const int kb = 3 * L + (int)((w0 >> 28) & 7u) * L;
#pragma unroll
      for (int k = 0; k < L; ++k) kp[k] = team_sm[kb + k];
      fe_sub_exact(o, a, b, kp);
    }
  }
  const int d = slot_word(t, (w0 >> 2) & 0xFFu, 0);
#pragma unroll
  for (int k = 0; k < L; ++k) team_sm[d + k * t.lpb] = o.v[k];
}

// Run schedule `s`: each level's instructions r, r + T, ... on rank r,
// then the team meets.
__device__ __forceinline__ void team_run(int s, const TeamLane& t,
                                         const Mod& M) {
  const int lv0 = (int)c_team.tab[TAB_RANGES + 2 * s];
  const int lv1 = (int)c_team.tab[TAB_RANGES + 2 * s + 1];
  const int ins = TEAM_HDR + (int)c_team.tab[TAB_LEVELS];
  for (int l = lv0; l < lv1; ++l) {
    const uint32_t w = c_team.tab[TEAM_HDR + l];
    const int first = (int)(w & 0xFFFFu), count = (int)(w >> 16);
    for (int q = t.rank; q < count; q += t.team)
      team_exec(ins + 3 * (first + q), t, M);
    __syncwarp(t.mask);
  }
}

// One base element of this thread's lane into slot s: `src` points at
// the element's limb 0 of this lane, limb k at src[k limb].
__device__ __forceinline__ void team_load_at(const int64_t* src, int64_t limb,
                                             uint32_t s, const TeamLane& t) {
  const int d = slot_word(t, s, 0);
#pragma unroll
  for (int k = 0; k < L; ++k)
    team_sm[d + k * t.lpb] = (uint32_t)src[(int64_t)k * limb];
}

// The same from the element's int64[L, lanes] limb array.
__device__ __forceinline__ void team_load(const int64_t* src, uint32_t s,
                                          const TeamLane& t, int64_t lanes) {
  team_load_at(src + t.i, lanes, s, t);
}

// The first n output slots of list `o` (O_ADD, O_RESET, O_FRESH) into out:
// base element e at e L lanes (int64[3, L, lanes] for G1, int64[3, 2, L,
// lanes] for G2).
__device__ __forceinline__ void team_store(int64_t* out, int o, int n,
                                           const TeamLane& t, int64_t lanes) {
  for (int e = t.rank; e < n; e += t.team) {
    const int s =
        slot_word(t, c_team.tab[TAB_OUTS + TEAM_N_OUT * o + e], 0);
    int64_t* dst = out + (int64_t)e * L * lanes + t.i;
#pragma unroll
    for (int k = 0; k < L; ++k)
      dst[(int64_t)k * lanes] = (int64_t)team_sm[s + k * t.lpb];
  }
}

// Host side: `blk` is the team block (team.py block()). Checks it, builds
// the constant image and uploads it on `stream` when it differs from the
// module's last upload; returns 0, BAD_TABLE or a CUDA error. For a kernel
// of kind `kind`: *smem gets the block's dynamic shared memory, *threads
// its threads, *lpb its lanes. Static: the record of the last upload
// belongs to this module's image (K2 and K6 G1 upload the same block).
static int team_prepare(const uint32_t* blk, int kind, cudaStream_t stream,
                        size_t* smem, int* threads, int* lpb) {
  static TeamImage last;
  static bool have = false;
  const uint32_t* tab = blk + TEAM_CONST_WORDS;
  for (int k = 0; k < TEAM_KINDS; ++k) {
    const uint32_t team = tab[3 * k], warps = tab[3 * k + 1];
    if (team < 1 || team > 32 || warps < 1 || warps > 8 ||
        tab[3 * k + 2] > CONST_SLOT)
      return BAD_TABLE;
  }
  const uint32_t words = TEAM_HDR + tab[TAB_LEVELS] + 3 * tab[TAB_INSTRS];
  if (words > (uint32_t)TEAM_WORDS) return BAD_TABLE;
  TeamImage img = {};
  memcpy(img.cst, blk, sizeof img.cst);
  memcpy(img.tab, tab, sizeof(uint32_t) * words);
  const uint32_t* lay = tab + 3 * kind;
  *threads = 32 * (int)lay[1];
  *lpb = (32 / (int)lay[0]) * (int)lay[1];
  *smem = sizeof(uint32_t) *
          (TEAM_CONST_WORDS + (size_t)lay[2] * L * (size_t)(*lpb));
  if (!have || memcmp(&img, &last, sizeof img) != 0) {
    const cudaError_t e = cudaMemcpyToSymbolAsync(
        c_team, &img, sizeof img, 0, cudaMemcpyHostToDevice, stream);
    if (e != cudaSuccess) return (int)e;
    last = img;
    have = true;
  }
  return 0;
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised.
static int team_smem_attr(const void* kernel, size_t smem, size_t* set) {
  if (smem <= 48 * 1024 || smem <= *set) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *set = smem;
  return 0;
}

// The launch of a team kernel's C entry point: prepare, raise the shared
// memory attribute if needed, launch over ceil(lanes / lpb) blocks with
// `launch(blocks, threads, smem)`, and return cudaGetLastError().
template <typename Launch>
static int team_launch(const uint32_t* blk, int kind, const void* kernel,
                       size_t* attr, int64_t lanes, void* stream,
                       Launch launch) {
  size_t smem;
  int threads, lpb;
  int rc = team_prepare(blk, kind, (cudaStream_t)stream, &smem, &threads,
                        &lpb);
  if (rc == 0) rc = team_smem_attr(kernel, smem, attr);
  if (rc != 0) return rc;
  launch((unsigned)((lanes + lpb - 1) / lpb), threads, smem);
  return (int)cudaGetLastError();
}

}  // namespace kzg
