// K6: the merge-strategy combine of the bucket accumulation, one launch per
// merge level, for G1 and for G2 (one source, templated on the group's
// base elements per point).
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
// unchanged, as the plain select does. mid is computed on every lane, as
// the plain version and the TPU kernel compute it.
//
// Bound on the card: a lane reads 4 points and 3 mask bytes and writes 3
// points (7 x 3 coordinates) and does one complete add (15 base products
// for G1, 48 for G2). A 4097-point MSM runs 13 levels, from 32 x 4096
// lanes down to 32 x 1. At the nine levels of at most 8192 lanes one
// lane's serial chain of products sets the time; at the four widest the
// product rate and the bytes do.
//
// Design: the lane teams of K2/K4 (team.cuh). A lane's aR and bL go into
// the first slots (3 base elements per G1 point, 6 per G2 point), the team
// runs its group's ADD schedule (kzg_tpu_torch/ops/team.py: the words,
// values and exact-subtraction slacks K2/K4 run), and the team's ranks
// share the 3 x 3 (G1) or 3 x 6 (G2) output elements:
// mid from its output slots in shared memory, newL and newR from the same
// slots where selected, else copied from aL or bR in device memory. The
// inputs are read in place: each coordinate comes with its lane, limb and
// component strides, so the stride-2 halves of a level's sums (aL, bL of
// sumL; aR, bR of sumR) need no copies. A launch of at least the table's
// WIDE lanes runs in K6's own layout (K_MERGE: G1 teams of 3, which hold
// twice the lanes per SM and win where the product rate sets the time),
// a narrower one in the add's (G1 teams of 6: fewer product rounds per
// lane, which win where one lane's chain does).
#include "team.cuh"

namespace kzg {

// The operands of one launch: the coordinate arrays of the four input
// points aL, aR, bL, bR (x, y, z each) and the masks fuse, asing, bsing,
// with the strides of each in elements (lane, limb, component): limb k of
// component c of lane i of coordinate q at pt[q][c st[q][2] + k st[q][1] +
// i st[q][0]]; mask m of lane i at mask[m][i st[12 + m][0]].
struct MergeArgs {
  const int64_t* pt[12];
  const uint8_t* mask[3];
  int64_t st[15][3];
};

// E base elements per point (3 for G1, 6 for G2: C = E / 3 components per
// coordinate). out: int64[3 (mid, newL, newR), E, L, lanes].
template <int E>
__global__ void __launch_bounds__(256)
merge_combine_kernel(const __grid_constant__ MergeArgs a,
                     int64_t* __restrict__ out, int64_t lanes, int kind,
                     Mod M) {
  constexpr int C = E / 3;
  TeamLane t;
  if (!team_setup(t, lanes, kind)) return;
  const bool fuse = a.mask[0][t.i * a.st[12][0]] != 0;
  const bool selL = fuse && a.mask[1][t.i * a.st[13][0]] != 0;
  const bool selR = fuse && a.mask[2][t.i * a.st[14][0]] != 0;
  for (int e = t.rank; e < 2 * E; e += t.team) {   // aR: P, bL: Q
    const int q = 3 * (1 + e / E) + (e % E) / C;
    team_load_at(a.pt[q] + (e % C) * a.st[q][2] + t.i * a.st[q][0],
                 a.st[q][1], (uint32_t)e, t);
  }
  __syncwarp(t.mask);
  team_run(S_ADD, t, M);
  for (int e = t.rank; e < 3 * E; e += t.team) {
    const int j = e / E, b = e - j * E;
    int64_t* dst = out + (int64_t)e * L * lanes + t.i;
    if (j == 0 || (j == 1 ? selL : selR)) {
      const int s =
          slot_word(t, c_team.tab[TAB_OUTS + TEAM_N_OUT * O_ADD + b], 0);
#pragma unroll
      for (int k = 0; k < L; ++k)
        dst[(int64_t)k * lanes] = (int64_t)team_sm[s + k * t.lpb];
    } else {
      const int q = (j == 1 ? 0 : 9) + b / C;        // aL or bR
      const int64_t* src =
          a.pt[q] + (b % C) * a.st[q][2] + t.i * a.st[q][0];
      const int64_t limb = a.st[q][1];
#pragma unroll
      for (int k = 0; k < L; ++k) dst[(int64_t)k * lanes] = src[k * limb];
    }
  }
}

template <int E>
static int merge_combine(const uint64_t* ptrs, const int64_t* strides,
                         int64_t* out, int64_t lanes, const uint32_t* consts,
                         int n_limbs, void* stream) {
  if (n_limbs != L) return BAD_LIMBS;
  MergeArgs a;
  for (int q = 0; q < 12; ++q) a.pt[q] = (const int64_t*)ptrs[q];
  for (int m = 0; m < 3; ++m) a.mask[m] = (const uint8_t*)ptrs[12 + m];
  for (int q = 0; q < 15; ++q)
    for (int k = 0; k < 3; ++k) a.st[q][k] = strides[3 * q + k];
  static size_t attr = 0;
  const Mod M = mod_from_host(consts);
  const uint32_t* blk = consts + CONST_WORDS;
  const int kind =
      lanes >= (int64_t)blk[TEAM_CONST_WORDS + TAB_WIDE] ? K_MERGE : K_ADD;
  return team_launch(
      blk, kind, (const void*)merge_combine_kernel<E>, &attr, lanes, stream,
      [&](unsigned blocks, int threads, size_t smem) {
        merge_combine_kernel<E><<<blocks, threads, smem,
                                  (cudaStream_t)stream>>>(a, out, lanes,
                                                          kind, M);
      });
}

}  // namespace kzg

// ptrs: host array of 15 device pointers, the x, y, z coordinates of aL,
// aR, bL, bR (each int64[n_limbs, lanes] for G1, int64[2, n_limbs, lanes]
// for G2, at any strides) and the uint8[lanes] masks fuse, asing, bsing;
// strides: host int64[15, 3], each pointer's lane, limb and component
// strides in elements (see MergeArgs); out: int64[3, 3, (2,) n_limbs,
// lanes] = mid, newL, newR, contiguous; consts: K1's modulus words, then
// the team block (ops/cuda.py _g1_consts / _g2_consts). Returns
// cudaGetLastError() after the launch, or BAD_LIMBS / BAD_TABLE / the
// error of the table's upload.
extern "C" int kzg_merge_combine_g1(const uint64_t* ptrs,
                                    const int64_t* strides, int64_t* out,
                                    int64_t lanes, const uint32_t* consts,
                                    int n_limbs, void* stream) {
  return kzg::merge_combine<3>(ptrs, strides, out, lanes, consts, n_limbs,
                               stream);
}

extern "C" int kzg_merge_combine_g2(const uint64_t* ptrs,
                                    const int64_t* strides, int64_t* out,
                                    int64_t lanes, const uint32_t* consts,
                                    int n_limbs, void* stream) {
  return kzg::merge_combine<6>(ptrs, strides, out, lanes, consts, n_limbs,
                               stream);
}
