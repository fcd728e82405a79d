// K4: G2 complete point add (with an optional per-lane reset mask) and
// K5: a chain of `times` G2 complete doublings, BN254's and BLS12-381's
// twists (a = 0, Fp2 with u^2 = -1) and BN158's (u^2 = 5); built at L = 17,
// 25 and 11 limbs.
//
// Replace the G2 instances of the JAX package's composite Pallas kernels
// (kzg_tpu/ops/fuse.py pl.pallas_call through fuse_composite /
// fuse_pointwise):
//   K4 <- T2 kzg_tpu/groups/ec.py Curve.add_f, T4 the chunked bucket step
//         kzg_tpu/ops/msm.py:268-274 select(s, p, add(c, p)) (the reset
//         mask), T6/T7 the weighted-reduction adds msm.py:511-514,535-536 —
//         on verify's G2 MSM, setup's G2 comb and the merge msm's Horner
//         tail;
//   K5 <- T3 kzg_tpu/groups/ec.py Curve.dbl_f(times), run by
//         MSMEngine.precompute_shifted (times = 8) over the G2 setup points
//         on the first verify, and by the merge msm's Horner tail.
//
// Bound on the card: an add reads 6 and writes 3 Fp2 coordinates (9 x 2 x
// L int64 limbs, 2448 bytes per lane at 17 limbs, 3600 at 25, 1584 at 11)
// and does 48
// base Montgomery products (14 Fp2 products of 3, 6 re-reductions); a
// doubling does 27.
// The paths launch them mostly narrow (1 lane in the Horner tail, 32 in
// setup's comb, tens to hundreds in verify's MSM, 5000 at most for the
// chains), where one lane's serial chain of products sets the time: 48 per
// add and 222 per chain of 8 when one thread owns a lane.
//
// Design (team.cuh, shared with K2/K3 and K6): each lane is owned by a
// team of threads (its layout comes with the schedule table,
// kzg_tpu_torch/ops/team.py). The point, the constants and every
// intermediate live in the block's shared memory; the formula runs as
// levels of independent instructions spread over the team, and no operand
// goes through a local stack frame. Two variants, picked by width
// (ops/cuda.py SPLIT_BELOW, per kernel and limb count):
//   lane (from the rule up):
//        teams of T threads of one warp, each product an inlined L x L
//        Montgomery product on operands in registers; a lane's chain falls
//        to the product rounds of its schedule (team.rounds: 7 per add and
//        4 per doubling at T = 8), a whole 25-limb product a round (~7 us);
//   split (below the rule: K4 and K5 at BLS12-381's 25 limbs, at BN158's
//        11 and at BN254's 17): each product of a level split by
//        columns over a sub-team of R ranks (mont.cuh's split product,
//        K1's lane teams), P products a round, the lane's team R x P
//        threads: one warp, or a whole block meeting at __syncthreads();
//        the schedule leveled for P products a round (team.rounds: 5 per
//        add and 3 per doubling at P = 16 of 16 ranks at 25 limbs; 5 per
//        add and 3 per doubling at P = 32 of 8 ranks at 11, 3 columns a
//        rank of the 22; at 17 5 per add and 3 per doubling at P = 16 of
//        16 ranks, 3 columns of the 34), a linear instruction a warp, a
//        lane a limb. A 25-limb round costs ~2 us: a
//        1-lane add ~0.018 ms against ~0.053 ms on the lane executor; at 11
//        limbs ~0.013 against ~0.025, and 1 lane x 8 doublings ~0.052
//        against ~0.102; at 17 a 1-lane add ~0.015 against ~0.034, and
//        1 lane x 8 doublings ~0.062 against ~0.141, K5's rule 397 lanes
//        where a second wave of blocks starts (runs AJ1, AJ2, PERF.md).
// Outputs are re-reduced: exact 16-bit limbs, each component < 1.1 p. K6
// (msm_merge.cu) runs the same add schedule on the lane executor.
#include "team.cuh"

namespace kzg {

// Base element e (coordinate e / 2, component e % 2) of a G2 point whose
// coordinates are int64[2, L, lanes]: P's in slots 0-5, Q's in 6-11.
__device__ __forceinline__ void g2_load(const int64_t* coord, int e,
                                        uint32_t s, const TeamLane& t,
                                        int64_t lanes) {
  team_load(coord + (int64_t)(e & 1) * L * lanes, s, t, lanes);
}

__global__ void __launch_bounds__(256)
g2_add_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
              const int64_t* __restrict__ pz, const int64_t* __restrict__ qx,
              const int64_t* __restrict__ qy, const int64_t* __restrict__ qz,
              const uint8_t* __restrict__ reset, int64_t* __restrict__ out,
              int64_t lanes, Mod M) {
  TeamLane t;
  if (!team_setup(t, lanes, K_ADD)) return;
  const bool rst = reset != nullptr && reset[t.i];
  for (int e = t.rank + (rst ? 6 : 0); e < 12; e += t.team) {
    const int c = e >> 1;
    const int64_t* src = c == 0 ? px : c == 1 ? py : c == 2 ? pz
                       : c == 3 ? qx : c == 4 ? qy : qz;
    g2_load(src, e, (uint32_t)e, t, lanes);
  }
  __syncwarp(t.mask);
  team_run(rst ? S_RESET : S_ADD, t, M);    // reset: Q re-reduced
  team_store(out, rst ? O_RESET : O_ADD, 6, t, lanes);
}

__global__ void __launch_bounds__(256)
g2_dbl_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
              const int64_t* __restrict__ pz, int64_t* __restrict__ out,
              int64_t lanes, int times, Mod M) {
  TeamLane t;
  if (!team_setup(t, lanes, K_DBL)) return;
  for (int e = t.rank; e < 6; e += t.team) {
    const int c = e >> 1;
    g2_load(c == 0 ? px : c == 1 ? py : pz, e, (uint32_t)e, t, lanes);
  }
  __syncwarp(t.mask);
  for (int step = 0; step <= times; ++step)  // the doublings stay in slots
    team_run(step < times ? S_DBL : S_FRESH, t, M);
  team_store(out, O_FRESH, 6, t, lanes);
}

// The split variants: the same loads, schedules and stores on the split
// executor, R ranks a product; a lane's base elements are loaded and its
// outputs stored limb by limb over the whole team.
template <int R>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS)
g2_add_split_kernel(const int64_t* __restrict__ px,
                    const int64_t* __restrict__ py,
                    const int64_t* __restrict__ pz,
                    const int64_t* __restrict__ qx,
                    const int64_t* __restrict__ qy,
                    const int64_t* __restrict__ qz,
                    const uint8_t* __restrict__ reset,
                    int64_t* __restrict__ out, int64_t lanes, Mod M) {
  TeamLane t;
  if (!split_setup(t, lanes, K_ADD, M)) return;
  const bool rst = reset != nullptr && reset[t.i];
  const int e0 = rst ? 6 : 0;
  for (int x = t.rank; x < (12 - e0) * L; x += t.team) {
    const int e = e0 + x / L, k = x % L, c = e >> 1;
    const int64_t* src = c == 0 ? px : c == 1 ? py : c == 2 ? pz
                       : c == 3 ? qx : c == 4 ? qy : qz;
    team_sm[slot_word(t, (uint32_t)e, k)] =
        (uint32_t)src[((int64_t)(e & 1) * L + k) * lanes + t.i];
  }
  split_sync(t);
  split_run<R>(rst ? S_RESET : S_ADD, t, M);
  split_store(out, rst ? O_RESET : O_ADD, 6, t, lanes);
}

// At 17 limbs ptxas gives the R = 16 form 72 registers and 8 B of spill
// (g1_ops.cu's too). A budget of one or two blocks an SM in the launch
// bounds removes it at 96 registers, but then two 256-thread blocks fit an
// SM, not three: 1.37 x the time at 384 lanes x 8; the chain's last
// (re-reducing) schedule run outside its loop removes it too, but spills
// 32 B in the R = 32 form, G1's (PERF.md, run AJ1).
template <int R>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS)
g2_dbl_split_kernel(const int64_t* __restrict__ px,
                    const int64_t* __restrict__ py,
                    const int64_t* __restrict__ pz,
                    int64_t* __restrict__ out, int64_t lanes, int times,
                    Mod M) {
  TeamLane t;
  if (!split_setup(t, lanes, K_DBL, M)) return;
  for (int x = t.rank; x < 6 * L; x += t.team) {
    const int e = x / L, k = x % L, c = e >> 1;
    const int64_t* src = c == 0 ? px : c == 1 ? py : pz;
    team_sm[slot_word(t, (uint32_t)e, k)] =
        (uint32_t)src[((int64_t)(e & 1) * L + k) * lanes + t.i];
  }
  split_sync(t);
  for (int step = 0; step <= times; ++step)
    split_run<R>(step < times ? S_DBL : S_FRESH, t, M);
  split_store(out, O_FRESH, 6, t, lanes);
}

}  // namespace kzg

// P, Q coordinates: int64[2, n_limbs, lanes] contiguous on the card; reset:
// uint8[lanes] or null; out: int64[3, 2, n_limbs, lanes]; consts: K1's
// modulus words of the base field then the team block (ops/cuda.py
// _g2_consts). out = reset ?
// Q : P + Q per lane. Returns cudaGetLastError() after the launch, or
// BAD_LIMBS / BAD_TABLE / the error of the table's upload.
extern "C" int kzg_g2_add(const int64_t* px, const int64_t* py,
                          const int64_t* pz, const int64_t* qx,
                          const int64_t* qy, const int64_t* qz,
                          const uint8_t* reset, int64_t* out, int64_t lanes,
                          const uint32_t* consts, int n_limbs, void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  static size_t attr = 0;
  const Mod M = mod_from_host(consts);
  return team_launch(
      consts + CONST_WORDS, K_ADD, (const void*)g2_add_kernel, &attr,
      lanes, stream, [&](unsigned blocks, int threads, size_t smem) {
        g2_add_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
            px, py, pz, qx, qy, qz, reset, out, lanes, M);
      });
}

// out = 2^times P per lane.
extern "C" int kzg_g2_dbl(const int64_t* px, const int64_t* py,
                          const int64_t* pz, int64_t* out, int64_t lanes,
                          int times, const uint32_t* consts, int n_limbs,
                          void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  static size_t attr = 0;
  const Mod M = mod_from_host(consts);
  return team_launch(
      consts + CONST_WORDS, K_DBL, (const void*)g2_dbl_kernel, &attr,
      lanes, stream, [&](unsigned blocks, int threads, size_t smem) {
        g2_dbl_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
            px, py, pz, out, lanes, times, M);
      });
}

// The split variants of both, same arguments; consts: K1's modulus words
// then the split block (ops/cuda.py _g2_consts(G, split=True)), whose
// layout words name R (8, 16 or 32) and the team. Returns as above.
extern "C" int kzg_g2_add_split(const int64_t* px, const int64_t* py,
                                const int64_t* pz, const int64_t* qx,
                                const int64_t* qy, const int64_t* qz,
                                const uint8_t* reset, int64_t* out,
                                int64_t lanes, const uint32_t* consts,
                                int n_limbs, void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  static size_t attrs[3] = {0, 0, 0};
  static const void* const kernels[3] = {
      (const void*)g2_add_split_kernel<8>,
      (const void*)g2_add_split_kernel<16>,
      (const void*)g2_add_split_kernel<32>};
  Mod M = mod_from_host(consts);
  void* args[] = {&px, &py, &pz, &qx, &qy, &qz, &reset, &out, &lanes, &M};
  return split_launch(consts + CONST_WORDS, K_ADD, kernels, attrs, lanes,
                      stream, args);
}

extern "C" int kzg_g2_dbl_split(const int64_t* px, const int64_t* py,
                                const int64_t* pz, int64_t* out,
                                int64_t lanes, int times,
                                const uint32_t* consts, int n_limbs,
                                void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  static size_t attrs[3] = {0, 0, 0};
  static const void* const kernels[3] = {
      (const void*)g2_dbl_split_kernel<8>,
      (const void*)g2_dbl_split_kernel<16>,
      (const void*)g2_dbl_split_kernel<32>};
  Mod M = mod_from_host(consts);
  void* args[] = {&px, &py, &pz, &out, &lanes, &times, &M};
  return split_launch(consts + CONST_WORDS, K_DBL, kernels, attrs, lanes,
                      stream, args);
}
