// The lane-team executor of K2/K3 (G1 complete add and doubling chain,
// g1_ops.cu), K4/K5 (G2, g2_ops.cu) and K6 (the merge combine of either
// group, msm_merge.cu): each lane of a batch is owned by a team of
// threads, and the team runs the lane's formula as a schedule of levels,
// read from a table that kzg_tpu_torch/ops/team.py builds (its docstring
// defines the instructions and the table's words).
// Nothing here knows the group: a kernel loads its point's base elements
// into the first slots, runs schedules and stores the output slots that
// the table names. K6 runs the add's schedule, in a layout of its own
// from the header's WIDE lanes up and in the add's below.
//
// The team block (the host array behind K1's 2 L + 2 modulus words in
// each group's constants, team.py block()): 8 constant rows of L words
// (the constant slots R mod p and two group constants, then the exact
// subtractions' five slacks m p), then the table. Shared memory of a
// kernel's block (dynamic, uint32 words):
//   [0, 8L)        the constant rows;
//   [8L, ...)      the lanes' slots, slot s limb k of lane j (in the block)
//                  at 8L + (s L + k) lpb + j, lpb = lanes per block: the
//                  teams of a warp touch neighbouring words;
//   then           the split executor's padded p, operand rows and table
//                  (split_setup).
// The table sits in constant memory (uploaded by the C entry points when it
// changes; each module has its own image): in a level every team of a warp
// reads the same instruction words for the same rank, so a warp's fetch is
// at most T distinct words. The add, doubling and merge kernels of a group
// have their own team layouts (header words 0-2, 3-5 and 6-8, and the
// ranks a product in words 38-40) and share one image, so alternating
// launches upload nothing.
//
// Two executors run the schedules. The lane executor (K6, and K2-K5 from
// their width rule up): one instruction runs in one thread,
// its operands (sums of up to four slots, times a small scale) loaded from
// shared memory into registers, a product the inlined mont_mul of
// mont.cuh (the form K1 runs near its byte bound), one unrolled L x L
// product in each of its kernels; K6 at 25 limbs runs the digit product
// mont_mul_d32 instead (team_run<true>), the same limbs from 32-bit
// digits. After each level the team meets at
// __syncwarp(team mask); a team never waits on threads outside it, so a
// team past the batch's end or a warp's spare threads may leave early.
//
// The split executor (below cuda.SPLIT_BELOW: K2-K5 at BLS12-381's 25
// limbs, at BN158's 11 and at BN254's 17): there one lane's chain of whole
// products sets the launch's time (a 25-limb product takes one thread ~7
// us a round), so each product of a level is split by columns over a
// sub-team of R ranks: the split product of mont.cuh that K1's lane teams
// run. A lane's team is R x P threads (P
// products a round), one warp or a whole block: a level of n products
// runs in ceil(n / P) rounds. In a round each sub-team first forms its
// product's operands from the slots into operand rows of its own (half its
// ranks a's limbs, half b's; b padded with zeros as K1 pads it), then
// every rank reads a and its window of b at fixed offsets. A warp whose
// sub-teams have no product left in a round skips it; a spare sub-team of
// a busy warp repeats the round's last product and stores nothing, so
// every shuffle, ballot and __syncwarp() names the whole warp. A linear
// instruction runs on a whole warp, a lane a limb: an EXACT's signed
// carries move up a lane a pass until none is left. The schedule is
// leveled for P products a round (team.py). A team of one warp meets at
// __syncwarp(), and W such teams share a block; a larger team is one lane
// per block and meets at __syncthreads(). Its table has an image of its
// own, in global memory, which each block copies into shared memory (a
// level's words then cost no constant-cache miss on the lane's chain), so
// launches of the two variants upload nothing when they alternate.
// The prologue (split_setup) copies that image word by word through
// registers, the block's threads a word each in turn. Staging it by
// Hopper's bulk asynchronous copy instead (cp.async.bulk on an mbarrier,
// the block zeroing the operand rows meanwhile) took 0.3-0.7 us off a
// launch of 1-128 lanes but up to 13% more at 256-512 and spilled more,
// so it does not ship (PERF.md).
// Shared memory and the constant rows grow with L (25 / 17 of BN254's at
// BLS12-381's 25 limbs, 11 / 17 at BN158's 11); the table does not depend
// on L.
#pragma once

#include <cstring>

#include "mont.cuh"

namespace kzg {

constexpr int TEAM_WORDS = 768;          // capacity of the schedule table
constexpr int TEAM_HDR = 41;             // its header (team.py HDR)
constexpr int TEAM_N_OUT = 6;            // output slot room per list
// header words after the kinds' layouts (team.py WIDE ... RANKS)
enum { TAB_WIDE = 9, TAB_LEVELS = 10, TAB_INSTRS = 11, TAB_RANGES = 12,
       TAB_OUTS = 20, TAB_RANKS = 38 };
constexpr uint32_t CONST_SLOT = 240;     // slot ids >= this are constants
constexpr int TEAM_CONST_WORDS = 8 * L;  // constant slots + slacks
constexpr int BAD_TABLE = 1002;
constexpr int CONST_WORDS = MOD_WORDS;  // K1's words before the team block
enum { T_MUL = 0, T_LAZY = 1, T_EXACT = 2 };
enum { S_ADD = 0, S_RESET = 1, S_DBL = 2, S_FRESH = 3 };
enum { O_ADD = 0, O_RESET = 1, O_FRESH = 2 };
enum { K_ADD = 0, K_DBL = 1, K_MERGE = 2, TEAM_KINDS = 3 };  // words 3 k

struct TeamImage {
  uint32_t cst[TEAM_CONST_WORDS];
  uint32_t tab[TEAM_WORDS];
};

__constant__ TeamImage c_team;           // the lane executor's table
__device__ TeamImage g_split;            // the split executor's (global:
                                         // each block copies it to shared)

extern __shared__ uint32_t team_sm[];

struct TeamLane {
  int team, rank, lpb, j;
  unsigned mask;
  int64_t i;                             // the lane in the batch
  int pz, sc, tb;                        // split: the padded p, the lane's
                                         // operand rows, the table (words
                                         // of shared memory, split_setup)
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

// One instruction: MUL, LAZY or EXACT (team.py), result into its slot; a
// MUL by mont_mul, or with Digit by the digit product mont_mul_d32.
template <bool Digit>
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
      if constexpr (Digit)
        mont_mul_d32(o, a, b, M);
      else
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
// then the team meets. Digit: the products are mont_mul_d32's.
template <bool Digit = false>
__device__ __forceinline__ void team_run(int s, const TeamLane& t,
                                         const Mod& M) {
  const int lv0 = (int)c_team.tab[TAB_RANGES + 2 * s];
  const int lv1 = (int)c_team.tab[TAB_RANGES + 2 * s + 1];
  const int ins = TEAM_HDR + (int)c_team.tab[TAB_LEVELS];
  for (int l = lv0; l < lv1; ++l) {
    const uint32_t w = c_team.tab[TEAM_HDR + l];
    const int first = (int)(w & 0xFFFFu), count = (int)(w >> 16);
    for (int q = t.rank; q < count; q += t.team)
      team_exec<Digit>(ins + 3 * (first + q), t, M);
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

// Host side: upload `img` to the image `symbol` on `stream`
// unless it equals `*last`, the record of that image's last upload in this
// module; returns 0 or the CUDA error.
static int image_upload(const TeamImage& img, const void* symbol,
                        TeamImage* last, bool* have, cudaStream_t stream) {
  if (*have && memcmp(&img, last, sizeof img) == 0) return 0;
  const cudaError_t e = cudaMemcpyToSymbolAsync(
      symbol, &img, sizeof img, 0, cudaMemcpyHostToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  *last = img;
  *have = true;
  return 0;
}

// The constant image of the block `blk` (team.py block()): its rows and
// table; false if the table does not fit.
static bool image_of(const uint32_t* blk, TeamImage* img) {
  const uint32_t* tab = blk + TEAM_CONST_WORDS;
  const uint32_t words = TEAM_HDR + tab[TAB_LEVELS] + 3 * tab[TAB_INSTRS];
  if (words > (uint32_t)TEAM_WORDS) return false;
  memset(img, 0, sizeof *img);
  memcpy(img->cst, blk, sizeof img->cst);
  memcpy(img->tab, tab, sizeof(uint32_t) * words);
  return true;
}

// `blk` is the team block (team.py block()). Checks it, builds the
// constant image and uploads it on `stream` when it differs from the
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
        tab[3 * k + 2] > CONST_SLOT || tab[TAB_RANKS + k] != 1)
      return BAD_TABLE;
  }
  TeamImage img;
  if (!image_of(blk, &img)) return BAD_TABLE;
  const uint32_t* lay = tab + 3 * kind;
  *threads = 32 * (int)lay[1];
  *lpb = (32 / (int)lay[0]) * (int)lay[1];
  *smem = sizeof(uint32_t) *
          (TEAM_CONST_WORDS + (size_t)lay[2] * L * (size_t)(*lpb));
  return image_upload(img, (const void*)&c_team, &last, &have, stream);
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

// ----------------------------------------------------------------------
// the split executor (header comment): R ranks a product, a lane's team
// of R x P threads, a warp or a whole block
// ----------------------------------------------------------------------

constexpr int SPLIT_MAX_THREADS = 288;   // a split kernel's block, at most
constexpr int SPLIT_PZ = 3 * L + 31;     // a padded row, at any R <= 32
constexpr int SPLIT_ROW = L + SPLIT_PZ;  // a sub-team's operand rows

// Place this thread in a split kernel of kind `kind`: rank in its lane's
// team of t.team threads (one warp, W lanes a block, or the whole block).
// Shared memory behind the lanes' slots: the padded p (L - 1 zeros, p_0 ..
// p_(L-1), zeros: every rank's window of p at t.pz + r C), each lane's
// operand rows, SPLIT_ROW words for each of its P sub-teams (a's L limbs,
// then b padded as p: written each round, the pads stay zero), then the
// table, copied from the global image so that a level's words are read
// from shared memory. Copies the constant rows, the table and p, zeros
// the rest. False for a lane past the end: its whole warp leaves. Every
// thread of the block calls it before any leaves.
__device__ __forceinline__ bool split_setup(TeamLane& t, int64_t lanes,
                                            int kind, const Mod& M) {
  const uint32_t* tab = g_split.tab;
  t.team = (int)tab[3 * kind];
  t.lpb = (int)blockDim.x / t.team;
  t.j = (int)threadIdx.x / t.team;
  t.rank = (int)threadIdx.x - t.j * t.team;
  t.i = (int64_t)blockIdx.x * t.lpb + t.j;
  t.pz = TEAM_CONST_WORDS + (int)tab[3 * kind + 2] * L * t.lpb;
  const int rows = t.team / (int)tab[TAB_RANKS + kind] * SPLIT_ROW;
  t.sc = t.pz + SPLIT_PZ + t.j * rows;
  t.tb = t.pz + SPLIT_PZ + t.lpb * rows;
  for (int w = threadIdx.x; w < TEAM_CONST_WORDS; w += blockDim.x)
    team_sm[w] = g_split.cst[w];
  for (int w = threadIdx.x; w < TEAM_WORDS; w += blockDim.x)
    team_sm[t.tb + w] = tab[w];
  for (int z = threadIdx.x; z < SPLIT_PZ + t.lpb * rows; z += blockDim.x)
    team_sm[t.pz + z] = 0u;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < L; ++k) team_sm[t.pz + L - 1 + k] = M.p[k];
  }
  __syncthreads();
  return t.i < lanes;
}

// The split table's word at `at` (its copy in shared memory).
__device__ __forceinline__ uint32_t split_tab(const TeamLane& t, int at) {
  return team_sm[t.tb + at];
}

// The team meets: a team of one warp at __syncwarp(), a larger one (the
// whole block) at __syncthreads().
__device__ __forceinline__ void split_sync(const TeamLane& t) {
  if (t.team == 32)
    __syncwarp();
  else
    __syncthreads();
}

// An operand decoded once: scale * (sum of n slots packed 8 bits each in
// `slots`), each slot's limb 0 and limb stride in shared memory.
struct Operand {
  int base[4], stride[4];
  uint32_t n, scale;
};

__device__ __forceinline__ Operand operand_of(uint32_t n, uint32_t slots,
                                             uint32_t scale,
                                             const TeamLane& t) {
  Operand o;
  o.n = n;
  o.scale = scale;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t s = (slots >> (8 * q)) & 0xFFu;
    const bool row = s >= CONST_SLOT;
    o.base[q] = row ? (int)(s - CONST_SLOT) * L : slot_word(t, s, 0);
    o.stride[q] = row ? 1 : t.lpb;
  }
  return o;
}

// Limb k of an operand (its loads issued together).
__device__ __forceinline__ uint32_t operand_limb(const Operand& o, int k) {
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < (int)o.n) v += team_sm[o.base[q] + k * o.stride[q]];
  return v * o.scale;
}

// One MUL instruction by the R ranks of sub-team u, this thread rank r:
// the sub-team forms a's and b's limbs from the operand slots into its
// rows (its first R / 2 ranks a's L limbs, the others b's), then each
// rank reads a and the window of b under its columns, at fixed offsets as
// K1 reads them, and runs the split product; its output limbs go to the
// destination slot where `store`. The whole warp runs it (its
// __syncwarp()s and shuffles).
template <int R>
__device__ __forceinline__ void split_exec(int at, int u, int r, bool store,
                                           const TeamLane& t,
                                           const Mod& M) {
  constexpr int C = SplitShape<R>::C, W = SplitShape<R>::W;
  const uint32_t w0 = split_tab(t, at);
  const int c0 = r * C;
  uint32_t* sa = team_sm + t.sc + u * SPLIT_ROW;
  uint32_t* sbz = sa + L;                    // b_y at sbz[L - 1 + y]
  {
    constexpr int H = R / 2;                 // ranks an operand
    const bool isb = r >= H;
    const Operand op =
        isb ? operand_of((w0 >> 25) & 7u, split_tab(t, at + 2),
                         (w0 >> 16) & 63u, t)
            : operand_of((w0 >> 22) & 7u, split_tab(t, at + 1),
                         (w0 >> 10) & 63u, t);
    uint32_t* row = isb ? sbz + L - 1 : sa;
    const int k0 = isb ? r - H : r;
    __syncwarp();                            // the last round's reads done
#pragma unroll
    for (int u = 0; u < (L + H - 1) / H; ++u) {
      const int k = k0 + u * H;
      if (k < L) row[k] = operand_limb(op, k);
    }
  }
  __syncwarp();
  uint64_t acc[C];
  {
    uint32_t ar[L], bw[W - 1];
#pragma unroll
    for (int x = 0; x < L; ++x) ar[x] = sa[x];
#pragma unroll
    for (int z = 0; z < W - 1; ++z) bw[z] = sbz[c0 + z];
    split_mul<R>(acc, ar, bw, team_sm + t.pz + c0, r,
                 ((int)threadIdx.x & 31) - r, M);
  }
  if (store) {
    const int d = slot_word(t, (w0 >> 2) & 0xFFu, 0);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int k = c0 + q - L;
      if (k >= 0 && k < L) team_sm[d + k * t.lpb] = (uint32_t)acc[q];
    }
  }
}

// One LAZY or EXACT instruction by a whole warp, this thread on limb k
// (lanes from L on hold zero): each lane forms its limb of scale * sum(a)
// (+ m p - scale * sum(b)); an EXACT's signed carries then move up a lane
// a pass, in 32-bit arithmetic (limbs of a and b below 2^30 keep every
// step inside an int32), until no lane below the top has one; the carry
// out of the top limb is dropped, as fe_sub_exact drops it.
__device__ __forceinline__ void split_linear(int at, int k,
                                             const TeamLane& t) {
  const uint32_t w0 = split_tab(t, at);
  const bool in = k < L;
  int32_t d = 0;
  if (in) {
    uint32_t v = operand_limb(operand_of((w0 >> 22) & 7u,
                                         split_tab(t, at + 1),
                                         (w0 >> 10) & 63u, t), k);
    if ((w0 & 3u) == T_EXACT)
      v += team_sm[3 * L + (int)((w0 >> 28) & 7u) * L + k] -
           operand_limb(operand_of((w0 >> 25) & 7u, split_tab(t, at + 2),
                                   (w0 >> 16) & 63u, t), k);
    d = (int32_t)v;
  }
  if ((w0 & 3u) == T_EXACT) {
    for (;;) {
      const int32_t c = d >> 16;         // arithmetic: floor division
      if (!__any_sync(0xFFFFFFFFu, k < L - 1 && c != 0)) break;
      const int32_t up = __shfl_up_sync(0xFFFFFFFFu, c, 1);
      d = (d & (int32_t)MASK16) + (k >= 1 && in ? up : 0);
    }
    d &= (int32_t)MASK16;
  }
  if (in) team_sm[slot_word(t, (w0 >> 2) & 0xFFu, k)] = (uint32_t)d;
}

// Run schedule `s` on the split executor: a product level in rounds of P
// = team / R products, sub-team u of the team on product u of a round; a
// linear level an instruction a warp; then the team meets.
template <int R>
__device__ __forceinline__ void split_run(int s, const TeamLane& t,
                                          const Mod& M) {
  const int per = t.team / R;
  const int sub = t.rank / R, r = t.rank - sub * R;
  const int wsub = (t.rank & ~31) / R;     // the warp's first sub-team
  const int lv0 = (int)split_tab(t, TAB_RANGES + 2 * s);
  const int lv1 = (int)split_tab(t, TAB_RANGES + 2 * s + 1);
  const int ins = TEAM_HDR + (int)split_tab(t, TAB_LEVELS);
  for (int l = lv0; l < lv1; ++l) {
    const uint32_t w = split_tab(t, TEAM_HDR + l);
    const int first = (int)(w & 0xFFFFu), count = (int)(w >> 16);
    if ((split_tab(t, ins + 3 * first) & 3u) == T_MUL) {
      for (int q0 = 0; q0 + wsub < count; q0 += per) {
        const int q = q0 + sub;            // a spare sub-team repeats the
        split_exec<R>(ins + 3 * (first + (q < count ? q : count - 1)), sub,
                      r, q < count, t, M); // last product, stores nothing
      }
    } else {
      for (int q = t.rank >> 5; q < count; q += t.team >> 5)
        split_linear(ins + 3 * (first + q), t.rank & 31, t);
    }
    split_sync(t);
  }
}

// The first n output slots of list `o` into out (as team_store), spread
// over the team: thread x stores limb x % L of element x / L.
__device__ __forceinline__ void split_store(int64_t* out, int o, int n,
                                            const TeamLane& t,
                                            int64_t lanes) {
  for (int x = t.rank; x < n * L; x += t.team) {
    const int e = x / L, k = x - e * L;
    const int s =
        slot_word(t, split_tab(t, TAB_OUTS + TEAM_N_OUT * o + e), k);
    out[((int64_t)e * L + k) * lanes + t.i] = (int64_t)team_sm[s];
  }
}

// Host side of a split kernel, as team_prepare: every kind's layout must be
// a team of one warp (1 to 18 warps a block, a lane each) or of a whole
// block of at most SPLIT_MAX_THREADS, R of 8, 16 or 32 ranks a product
// dividing the team; *ranks gets the kind's R. Its own image and record.
static int split_prepare(const uint32_t* blk, int kind, cudaStream_t stream,
                         size_t* smem, int* threads, int* lpb, int* ranks) {
  static TeamImage last;
  static bool have = false;
  const uint32_t* tab = blk + TEAM_CONST_WORDS;
  for (int k = 0; k < TEAM_KINDS; ++k) {
    const uint32_t team = tab[3 * k], warps = tab[3 * k + 1];
    const uint32_t r = tab[TAB_RANKS + k];
    const bool warp = team == 32 && warps >= 1 &&
                      32 * warps <= (uint32_t)SPLIT_MAX_THREADS;
    const bool block = team > 32 && team % 32 == 0 && 32 * warps == team &&
                       team <= (uint32_t)SPLIT_MAX_THREADS;
    if (!(warp || block) || (r != 8 && r != 16 && r != 32) ||
        team % r != 0 || tab[3 * k + 2] > CONST_SLOT)
      return BAD_TABLE;
  }
  TeamImage img;
  if (!image_of(blk, &img)) return BAD_TABLE;
  const uint32_t* lay = tab + 3 * kind;
  *threads = 32 * (int)lay[1];
  *lpb = *threads / (int)lay[0];
  *ranks = (int)tab[TAB_RANKS + kind];
  const size_t rows = (size_t)(lay[0] / *ranks) * SPLIT_ROW;
  *smem = sizeof(uint32_t) * (TEAM_CONST_WORDS + SPLIT_PZ + TEAM_WORDS +
                              ((size_t)lay[2] * L + rows) * (size_t)(*lpb));
  return image_upload(img, (const void*)&g_split, &last, &have, stream);
}

// The launch of a split kernel's C entry point: prepare, take the kernel
// built for the table's R (kernels[0], [1], [2]: R = 8, 16, 32; attrs
// their raised shared memory), and launch it over ceil(lanes / lpb)
// blocks with the kernel's arguments `args`; returns cudaGetLastError().
static int split_launch(const uint32_t* blk, int kind,
                        const void* const* kernels, size_t* attrs,
                        int64_t lanes, void* stream, void** args) {
  size_t smem;
  int threads, lpb, ranks;
  int rc = split_prepare(blk, kind, (cudaStream_t)stream, &smem, &threads,
                         &lpb, &ranks);
  const int v = ranks == 8 ? 0 : ranks == 16 ? 1 : 2;
  if (rc == 0) rc = team_smem_attr(kernels[v], smem, &attrs[v]);
  if (rc != 0) return rc;
  const cudaError_t e = cudaLaunchKernel(
      kernels[v], dim3((unsigned)((lanes + lpb - 1) / lpb)), dim3(threads),
      args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace kzg

