// K2: G1 complete point add (with an optional per-lane reset mask) and
// K3: a chain of `times` G1 complete doublings, BN254, BLS12-381 and BN158
// (a = 0; built at L = 17, 25 and 11 limbs, mont.cuh).
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
//         MSMEngine.precompute_shifted with times = 8 and by the merge
//         msm's Horner tail.
//
// Bound on the card: an add reads 6 and writes 3 coordinates (9 x L int64
// limbs, 1224 bytes per lane at 17 limbs, 1800 at 25, 792 at 11) and does
// 12 Montgomery products plus 3 to re-reduce its outputs; a doubling does 9
// (4, then 3, then 2 independent ones). On BN158, whose 3b = 39 is a
// product and not a lazy scale, an add does 14 and a doubling 10. The paths launch them narrow (32
// lanes in setup's comb and the bucket scans' tails, a few hundred to a
// few thousand per chunked bucket step, 1 lane x 8 in the merge msm's
// Horner tail, 5000 x 8 for the shifted bases), where one lane's serial
// chain of products sets the time when one thread owns a lane: 15
// products per add, 75 per chain of 8.
//
// Design (team.cuh, shared with K4/K5 and K6): each lane is owned by a
// team of threads (its layout comes with the schedule table,
// kzg_tpu_torch/ops/team.py; the add and the doubling have their own).
// The point, the constants and every intermediate live in the block's
// shared memory; the formula runs as levels of independent instructions
// spread over the team. Two variants, picked by width (ops/cuda.py
// SPLIT_BELOW, per kernel and limb count):
//   lane (from the rule up; K3's at every width at 17 limbs):
//        teams of T threads of one warp, each product an inlined L x L
//        Montgomery product on operands in registers; a lane's chain falls
//        to the product rounds of its schedule (team.rounds: 3 per add at
//        T = 6, 3 per doubling at T = 3; 4 and 4 on BN158), a whole
//        25-limb product a round (~7 us);
//   split (below the rule: K2 and K3 at BLS12-381's 25 limbs and at
//        BN158's 11, K2 at BN254's 17): each product of a level split by columns over a
//        sub-team of R ranks (mont.cuh's split product, K1's lane teams),
//        P products a round, the lane's team R x P threads: one warp (W
//        lanes a block), or a whole block meeting at __syncthreads(); the
//        schedule leveled for P products a round, a linear instruction a
//        warp, a lane a limb (g2_ops.cu's split kernels on the same
//        executor). At 11 limbs a product has 22 columns: K2's and K3's
//        team is 12 products a round of 16 ranks (2 columns a rank), 4
//        rounds an add and 3 a doubling (1 lane x 8 ~0.037 ms against
//        ~0.060 on the lane executor, PERF.md). At 17 limbs (34 columns)
//        K2's team is 12 products a round of 16 ranks, 3 rounds an add
//        (1 lane ~0.009 ms against ~0.015).
// The subtractions are exact with the slack m p of the plain version's
// lazy ones, so every product sees the plain version's values. Outputs
// are re-reduced: exact 16-bit limbs, value < 1.1 p. K6 (msm_merge.cu)
// runs the same add schedule on the lane executor.
#include "team.cuh"

namespace kzg {

__global__ void __launch_bounds__(256)
g1_add_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
              const int64_t* __restrict__ pz, const int64_t* __restrict__ qx,
              const int64_t* __restrict__ qy, const int64_t* __restrict__ qz,
              const uint8_t* __restrict__ reset, int64_t* __restrict__ out,
              int64_t lanes, Mod M) {
  TeamLane t;
  if (!team_setup(t, lanes, K_ADD)) return;
  const bool rst = reset != nullptr && reset[t.i];
  for (int e = t.rank + (rst ? 3 : 0); e < 6; e += t.team) {
    const int64_t* src = e == 0 ? px : e == 1 ? py : e == 2 ? pz
                       : e == 3 ? qx : e == 4 ? qy : qz;
    team_load(src, (uint32_t)e, t, lanes);   // P in slots 0-2, Q in 3-5
  }
  __syncwarp(t.mask);
  team_run(rst ? S_RESET : S_ADD, t, M);    // reset: Q re-reduced
  team_store(out, rst ? O_RESET : O_ADD, 3, t, lanes);
}

__global__ void __launch_bounds__(256)
g1_dbl_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
              const int64_t* __restrict__ pz, int64_t* __restrict__ out,
              int64_t lanes, int times, Mod M) {
  TeamLane t;
  if (!team_setup(t, lanes, K_DBL)) return;
  for (int e = t.rank; e < 3; e += t.team)
    team_load(e == 0 ? px : e == 1 ? py : pz, (uint32_t)e, t, lanes);
  __syncwarp(t.mask);
  for (int step = 0; step <= times; ++step)  // the doublings stay in slots
    team_run(step < times ? S_DBL : S_FRESH, t, M);
  team_store(out, O_FRESH, 3, t, lanes);
}

// The split variants: the same loads, schedules and stores on the split
// executor, R ranks a product; a lane's coordinates are loaded and its
// outputs stored limb by limb over the whole team.
template <int R>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS)
g1_add_split_kernel(const int64_t* __restrict__ px,
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
  const int e0 = rst ? 3 : 0;              // reset: Q only
  for (int x = t.rank; x < (6 - e0) * L; x += t.team) {
    const int e = e0 + x / L, k = x % L;
    const int64_t* src = e == 0 ? px : e == 1 ? py : e == 2 ? pz
                       : e == 3 ? qx : e == 4 ? qy : qz;
    team_sm[slot_word(t, (uint32_t)e, k)] =
        (uint32_t)src[(int64_t)k * lanes + t.i];
  }
  split_sync(t);
  split_run<R>(rst ? S_RESET : S_ADD, t, M);
  split_store(out, rst ? O_RESET : O_ADD, 3, t, lanes);
}

template <int R>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS)
g1_dbl_split_kernel(const int64_t* __restrict__ px,
                    const int64_t* __restrict__ py,
                    const int64_t* __restrict__ pz,
                    int64_t* __restrict__ out, int64_t lanes, int times,
                    Mod M) {
  TeamLane t;
  if (!split_setup(t, lanes, K_DBL, M)) return;
  for (int x = t.rank; x < 3 * L; x += t.team) {
    const int e = x / L, k = x % L;
    const int64_t* src = e == 0 ? px : e == 1 ? py : pz;
    team_sm[slot_word(t, (uint32_t)e, k)] =
        (uint32_t)src[(int64_t)k * lanes + t.i];
  }
  split_sync(t);
  for (int step = 0; step <= times; ++step)
    split_run<R>(step < times ? S_DBL : S_FRESH, t, M);
  split_store(out, O_FRESH, 3, t, lanes);
}

}  // namespace kzg

// P, Q coordinates: int64[n_limbs, lanes] contiguous on the card; reset:
// uint8[lanes] or null; out: int64[3, n_limbs, lanes]; consts: K1's
// modulus words then the team block (ops/cuda.py _g1_consts). out = reset ? Q
// : P + Q per lane. Returns cudaGetLastError() after the launch, or
// BAD_LIMBS / BAD_TABLE / the error of the table's upload.
extern "C" int kzg_g1_add(const int64_t* px, const int64_t* py,
                          const int64_t* pz, const int64_t* qx,
                          const int64_t* qy, const int64_t* qz,
                          const uint8_t* reset, int64_t* out, int64_t lanes,
                          const uint32_t* consts, int n_limbs, void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  static size_t attr = 0;
  const Mod M = mod_from_host(consts);
  return team_launch(
      consts + CONST_WORDS, K_ADD, (const void*)g1_add_kernel, &attr,
      lanes, stream, [&](unsigned blocks, int threads, size_t smem) {
        g1_add_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
            px, py, pz, qx, qy, qz, reset, out, lanes, M);
      });
}

// out = 2^times P per lane.
extern "C" int kzg_g1_dbl(const int64_t* px, const int64_t* py,
                          const int64_t* pz, int64_t* out, int64_t lanes,
                          int times, const uint32_t* consts, int n_limbs,
                          void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  static size_t attr = 0;
  const Mod M = mod_from_host(consts);
  return team_launch(
      consts + CONST_WORDS, K_DBL, (const void*)g1_dbl_kernel, &attr,
      lanes, stream, [&](unsigned blocks, int threads, size_t smem) {
        g1_dbl_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
            px, py, pz, out, lanes, times, M);
      });
}

// The split variants of both, same arguments; consts: K1's modulus words
// then the split block (ops/cuda.py _g1_consts(G, split=True)), whose
// layout words name R (8, 16 or 32) and the team. Returns as above.
extern "C" int kzg_g1_add_split(const int64_t* px, const int64_t* py,
                                const int64_t* pz, const int64_t* qx,
                                const int64_t* qy, const int64_t* qz,
                                const uint8_t* reset, int64_t* out,
                                int64_t lanes, const uint32_t* consts,
                                int n_limbs, void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  static size_t attrs[3] = {0, 0, 0};
  static const void* const kernels[3] = {
      (const void*)g1_add_split_kernel<8>,
      (const void*)g1_add_split_kernel<16>,
      (const void*)g1_add_split_kernel<32>};
  Mod M = mod_from_host(consts);
  void* args[] = {&px, &py, &pz, &qx, &qy, &qz, &reset, &out, &lanes, &M};
  return split_launch(consts + CONST_WORDS, K_ADD, kernels, attrs, lanes,
                      stream, args);
}

extern "C" int kzg_g1_dbl_split(const int64_t* px, const int64_t* py,
                                const int64_t* pz, int64_t* out,
                                int64_t lanes, int times,
                                const uint32_t* consts, int n_limbs,
                                void* stream) {
  using namespace kzg;
  if (n_limbs != L) return BAD_LIMBS;
  static size_t attrs[3] = {0, 0, 0};
  static const void* const kernels[3] = {
      (const void*)g1_dbl_split_kernel<8>,
      (const void*)g1_dbl_split_kernel<16>,
      (const void*)g1_dbl_split_kernel<32>};
  Mod M = mod_from_host(consts);
  void* args[] = {&px, &py, &pz, &out, &lanes, &times, &M};
  return split_launch(consts + CONST_WORDS, K_DBL, kernels, attrs, lanes,
                      stream, args);
}
