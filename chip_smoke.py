#!/usr/bin/env python3
"""Card smoke run of the PyTorch/CUDA port (kzg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line with what it checked and its time; any
mismatch or exception exits non-zero before the result line):
  1. build   — compiles the port's CUDA sources with nvcc for sm_90a, one
               process per source and limb count (all four at 17 limbs for
               BN254 and BLS12-381's Fr, at 25 for BLS12-381's Fp and at 11
               for BN158), all started together, prints each build's
               ptxas register, stack and spill lines and the card's name and
               power limit;
  2. kernels — K1 (Montgomery multiply) at 4096, 131072 and 811008 lanes on
               Fp and Fr with lazy input limbs, and both of its variants
               (lane teams, a thread per lane) at the team's ragged
               widths (1, T - 1, T + 1 lanes, one lane past a block), at
               108, 216 and 4096 lanes, either side of the width rule
               (K1_TEAM_BELOW - 1, K1_TEAM_BELOW) and at those three;
               K2/K4 (G1/G2 complete add, with and without reset mask;
               on both executors, split and lane, whose output limbs must
               be equal, K2's products reaching ~1082 p)
               and K3/K5 (G1/G2 doubling chain, times 1 and 8) over 8200
               lanes with infinity, doubling and negation cases, K2-K5
               again at the ragged widths of their
               lane teams (1, 5, 31, 32, 33, 127, 8193 lanes); K6 (merge
               combine, G1 and G2) over 8200 lanes with random masks, from
               contiguous inputs and from the stride-2 halves of two
               interleaved sums (a merge level's form, read in place), and
               at the ragged widths with every mask pattern: each held
               against its plain PyTorch version on the same card tensors
               (exact equality of limbs or of canonical affine points),
               outputs checked fresh (exact 16-bit limbs, < 1.1p) and
               sampled lanes against python-int arithmetic; then the same
               checks on BLS12-381: K1 at 25 limbs on Fp, with lanes whose
               inputs reach the G1 add's widest product operands (12 x 247
               p with limbs up to 786,420, times ~248 p), and the 17-limb
               K1 on BLS12-381's Fr; K2-K6 at 25 limbs (K2's products reach
               ~2964 p, checked on the statistics of both executors'
               schedules; K2-K5 on both executors, split and lane, at every
               check); and on
               BN158: K1 at 11 limbs on Fp and Fr, with lanes at the G1
               add's widest operands (~186 p times ~186 p) and at the G2
               Karatsuba's (8 (c0 + c1) of qnr = 5 products, limbs up to
               56 x 65535), and K2-K6 at 11 limbs (G1 with 3b = 39 a
               product, G2 with qnr = 5; K2-K5 on both executors);
  2b. split_fit — the fixed cost of a split launch: K3 and K5 at 25 and 11
               limbs on the split executor (cuda.g1_dbl / g2_dbl with
               team=True) at 1 lane, times = 1, 2, 4, 8, each exact against
               the plain chain; per kernel the least-squares line ms =
               intercept + slope x times (the intercept: launch, prologue,
               loads, the re-reduction and the store; the slope: one
               doubling) in a split_fit JSON line;
  3. golden  — reproduces the BN254 and the BLS12-381 golden bytes of
               tests/fixtures/golden/ from their 48-term setup files,
               verifies the whole-message proof and refutes a changed
               byte; on BN158 (no golden file) an 8-term setup from a
               known secret s: the commitment and two proofs equal the
               python-int oracle's [p(s)] G1 and [q(s)] G1, verify true,
               refutation false;
  4. main    — the main path of bench.py at full size: from_secret setup of
               5000 terms (with its oracle self-check), from_blob of 4097
               characters (degree 4096), create_commit, create_proof(p, 0, 1),
               verify_proof true and a one-bit refutation false (commitment
               and proof also equal the oracle's [p(s)] G1 and [q(s)] G1);
               cold times, warm medians and each kernel's launches on the
               path (K1-K5 must all run); then one warm from_blob, commit,
               proof and verify under torch.profiler (device time, busy
               share, launches and the kernels that take the most device
               time);
  5. msm     — the merge strategy's path (msm over arbitrary bases, the
               JAX package's TPU path for msm), on the main phase's setup
               and polynomial: G1 over the first 4097 setup points equals
               the commitment, G2 over the first 4097 G2 setup points equals
               the chunked G2 msm_shifted; log and scan at 256 points equal
               chunked; cold time, warm median and launches per call (K6
               must run); then one warm merge msm call per group under
               torch.profiler (device time, busy share, launches);
  6. main_bls — the main path again on BLS12-381 (the curve of the
               reference's three-curve harness) at the same sizes, with its
               own main_path_bls and profile_bls JSON lines; K1 (17 limbs,
               Fr: the NTT butterflies and the pairing's tower products are
               Fp products at 25), K1-K5 at 25 limbs must all run; then its
               msm phase (msm_bls JSON line, K6 at 25 limbs must run);
  7. main_bn158 — the same on BN158 (11 limbs, qnr = 5, an M-twist with a
               BN loop and tail), main_path_bn158 and profile_bn158 lines,
               K1-K5 at 11 limbs must all run; then its msm phase
               (msm_bn158, K6 at 11 limbs must run);
  8. multiproof — proofs above MULTIEVAL_DIRECT = 256 points on the BN254
               main phase's setup and polynomial: create_proof(p, 0, k) for
               k = 257 (segments 256 + 1), 512 and 4096 (the subproduct-tree
               branch of multieval) equals the oracle's [q(s)] G1 (a
               barycentric O(k) form, held to the O(k^2) one at small k) and
               verifies; a flipped byte is refuted at k = 257; its launches
               and shapes join BN254's paths in the sweep;
  9. native  — the native codec library (kzg_tpu_torch/native.py, host
               C++) built with the machine's C++ compiler (compiler and
               seconds printed); each method exactly equal to its plain
               python version at the main path's sizes (4096 chunks of 31
               bytes; the G1 and G2 coordinates of the 5000-term setup's
               kzg_public bytes; the degree-4096 polynomial's stream; a
               proof's hex); a short buffer raises; blob.from_bytes ->
               from_blob at 4096 chunks (the limb matrix uploaded without
               python ints) gives the device coefficients of the ints path,
               both timed on the host; K1 must run;
 10. cli     — kzg_tpu_torch.cli in-process from a peer directory beside a
               shared/: setup 5000 (its export reloaded), then on the main
               path's setup commit, prove (both through the native
               library's limb matrix), verify (exit 0) and a flipped
               byte (exit 1) of a 126,975-byte file (4096 chunks when
               padded), commitment and proof equal to the oracle's; BLS12-381
               and BN158 commit, prove and verify once on the demo's document
               against a 16-term setup from a known secret; wall ms and
               launches per command;
 11. demo    — kzg_tpu_torch.demo.run_demo() (demo/run-demo on a copy, its
               kzg-cli the port's CLI): exit 0, both hours' storage proofs
               VALID, "demo complete";
 12. parallel — 4 ranks sharing the card over gloo, then 1 rank over nccl
               (torch.multiprocessing spawn, a file:// rendezvous):
               sharded_msm (merge) over 4096 points ==
               the single-process msm (G1, G2), sharded_setup_powers of the
               5000-term setup == from_secret's points (G1, G2),
               DistributedNTT forward / inverse / conv == PolyEngine's on
               BLS12-381's Fr at n = 8192 and BN158's at 4096; wall ms and
               launches per rank;
 13. kernels line — each kernel held against its plain version once more at
               the heaviest shape its path gave it, then one JSON object:
               each kernel's launches on its curve's main and msm paths
               (and BN254's multiproof path), its largest error against the plain version, its device time
               per launch, the plain version's time per call, and the bound
               at that shape; before it the "sweep" line: K1-K6 of each
               limb count held against their plain versions and timed at
               every distinct shape their curve's paths launched, with each
               path's device time in the kernel (path_ms = sum of launches x
               ms) and above its bound (gap_ms = sum of launches x (ms -
               bound)); K1 in both variants (team_ms, lane_ms, `ships`: the
               one the width rule picks, which ms is) beside floor_ms, an
               empty kernel's launch on the shipped variant's grid, and the
               lane-team variant must have run on each main path; each
               point kernel whose width rule has an entry at its limb
               count (K2-K5 at 25 and at 11, K2 and K4 at 17) likewise
               in both
               variants (split_ms,
               lane_ms, ships, floor_ms; each variant an entry of the
               kernels line with its own launches, and the split executor
               must have run); K6 also
               timed from a merge level's stride-2 halves, the wrapper's
               copies included (halves_ms, halves_path_ms), and at 25
               limbs (team.MERGE_DIGITS: products on 32-bit digits) its
               raw output limb for limb against team.plain_merge's.
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --main-only

runs phase 4 alone on BN254 (main_path and profile lines, no result
line).
"""

import collections
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SEED = 20261016
SETUP_TERMS = 5000
DEGREE = 4096
WARM_RUNS = 3
K1_LANES = (4096, 131072, 811008)        # scripts/tpu_checks.py's sizes
K23_LANES = 8200
FIT_LIMBS = (25, 11)                     # the split fit's limb counts
FIT_TIMES = (1, 2, 4, 8)                 # and its chains
EDGE_LANES = (1, 5, 31, 32, 33, 127, 8193)   # K2-K6 ragged team edges
MSM_POINTS = DEGREE + 1                  # the merge msm of the msm phase
MSM_SCAN_POINTS = 256                    # its log and scan strategies
MAIN_KERNELS = ("mont_mul", "g1_add", "g1_dbl", "g2_add", "g2_dbl")
BLS = "BLS12381"
BN158 = "BN158"
# the kernels of each curve's main path, by their launch counters: BN254
# at 17 limbs; BLS12-381 K1 at 17 limbs on Fr, K1-K5 at 25 on Fp; BN158
# K1-K5 at 11 (Fp and Fr)
PATH_KERNELS = {"BN254": MAIN_KERNELS,
                BLS: ("mont_mul", "mont_mul@25", "g1_add@25", "g1_dbl@25",
                      "g2_add@25", "g2_dbl@25"),
                BN158: tuple(f"{k}@11" for k in MAIN_KERNELS)}
# each curve's phase label and JSON suffix
LABEL = {"BN254": ("main", ""), BLS: ("main_bls", "_bls"),
         BN158: ("main_bn158", "_bn158")}
MAIN_SECRET = 0xBEEF_CAFE_0123           # bench.py's setup secret
# the cli phase: a file of 4096 chunks of 31 bytes less one byte (the CLI
# pads it to 4096 chunks: the main path's width), the seed of its prove, and
# BLS12-381's and BN158's setup from a known secret for the demo's document
# (9 and 14 chunks: commit needs more terms than chunks)
CLI_FILE_BYTES = 4096 * 31 - 1
CLI_SEED = 20261018
CLI_SMALL_TERMS = 16
CLI_SMALL_SECRET = 0xC0FFEE_1234_5678_9ABC_DEF0
MULTIPROOF_K = (257, 512, 4096)          # above MULTIEVAL_DIRECT = 256
# the demo phase: Z(s) and q(s) of a storage proof of the demo's document
# whose pairing check ends its Miller loop with T's lazy y past 8 p
# (tests/test_torch_protocol.py holds the same check on the CPU)
DEMO_WIDE_Y = (
    0xcec23b30e5aa9b7002b56f7d78b69328d4e78a1a48f4aef87bbabde122eff85,
    0x36d35d02275fee6ea216b78cf066f9e975a17ffadedbaf1521e48c2f34b49ff)
# the parallel phase: ranks sharing the one card, the sharded msm's points
# (a multiple of the ranks) and the four-step NTT's sizes per curve; the
# groups it forms: the ranks over gloo (staged through the host), then one
# rank over nccl (device tensors straight to the collectives)
NATIVE_CHUNKS = 4096                     # the native phase's blob
NATIVE_CHUNK = 31
NATIVE_RUNS = 5                          # host-clock means of the codecs
PAR_RANKS = 4
PAR_RUNS = ((PAR_RANKS, "gloo"), (1, "nccl"))
PAR_MSM_POINTS = 4096
PAR_NTT = {"BLS12381": 8192, "BN158": 4096}
# published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores (67 TFLOP/s, an FMA counted as two
# operations), taken as the ceiling for the kernels' integer
# multiply-accumulates (each also counted as two operations); the card's
# 32-bit integer multiply rate is lower, so this bound is optimistic
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


def macs_per_mul(L):
    """16-bit multiply-accumulates of one L-limb Montgomery product:
    product plus reduction."""
    return 2 * L * L + L


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def line(phase, t0, msg):
    print(f"[{phase}] {msg} ({time.time() - t0:.2f}s)", flush=True)


def sync():
    torch.cuda.synchronize()


def event_ms(fn, iters=10):
    """Mean time of one call of fn between CUDA events around `iters`
    back-to-back calls. When the host enqueues a call more slowly than the
    card runs it, this is the host's rate, not the kernel's."""
    fn()
    fn()
    sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    sync()
    return a.elapsed_time(b) / iters


def kernel_ms(fn, iters=10):
    """Device time of one call of fn, a wrapper that launches one kernel:
    a spin kernel (torch.cuda._sleep) holds the stream while the host
    enqueues `iters` calls, so the CUDA events around them time the
    launches back to back on the card, without the host's enqueue gaps.
    The spin is lengthened until it outlasts the enqueue."""
    fn()
    sync()
    cycles = 1 << 24                   # ~8 ms at the H100's boost clock
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        sync()
        if enqueue_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
    raise RuntimeError("kernel_ms: the host's enqueue outlasted the spin")


def host_ms(fn, runs):
    """(cold_ms, warm_median_ms) on the host clock, each run synchronised."""
    t0 = time.time()
    out = fn()
    sync()
    cold = (time.time() - t0) * 1e3
    warm = []
    for _ in range(runs):
        t0 = time.time()
        fn()
        sync()
        warm.append((time.time() - t0) * 1e3)
    return out, cold, statistics.median(warm) if warm else None


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------

def lazy_limbs(F, lanes, gen):
    """(L, lanes) int64 limbs at the mul input contract's edges: values up
    to ~9 * 2^(16 (L - 1)) (< 64 p for BN254, < 90 p for BLS12-381's Fp)
    with limbs up to ~2^22 (random borrows of up to 63 * 2^16 from the limb
    above)."""
    dev = F.device
    L = F.L
    x = torch.randint(0, 1 << 16, (L, lanes), generator=gen, device=dev)
    x[L - 1] = torch.randint(0, 9, (lanes,), generator=gen, device=dev)
    x[:, 0] = 0                                         # value 0
    x[:, 1] = F.p_limbs                                 # value p
    x[:, 2] = F.p_limbs
    x[0, 2] -= 1                                        # p - 1
    for i in range(L - 1):
        t = torch.randint(0, 64, (lanes,), generator=gen, device=dev)
        t = torch.minimum(t, x[i + 1])
        x[i] += t << 16
        x[i + 1] -= t
    return x


def to_int(col):
    return sum(int(v) << (16 * j) for j, v in enumerate(col))


def point_inputs(ctx, G, og, pool_size, lanes, rng):
    """Two batches of `lanes` points of group G (og its oracle): pool points
    under a random projective rescaling, with infinity, P == Q and Q == -P
    lanes."""
    pool = [og.mul(rng.randrange(1, ctx.cp.r), og.gen)
            for _ in range(pool_size)]
    pts_p = [pool[rng.randrange(pool_size)] for _ in range(lanes)]
    pts_q = [pool[rng.randrange(pool_size)] for _ in range(lanes)]
    for j in range(0, lanes - 7, 8):
        pts_q[j] = pts_p[j]                              # doubling
        pts_q[j + 1] = og.neg(pts_p[j + 1])              # negation
        pts_p[j + 2] = None                              # inf + Q
        pts_q[j + 3] = None                              # P + inf
        pts_p[j + 4] = pts_q[j + 4] = None               # inf + inf
    F = G.F
    p = ctx.fp.modulus

    def rescale(P):
        lam = [rng.randrange(1, p) for _ in range(lanes)]
        if G.is_fp2:
            lam = [(rng.randrange(p), v) for v in lam]
        lam = F.encode(lam)
        x, y, z = F.mul_many([(P["x"], lam), (P["y"], lam), (P["z"], lam)])
        return {"x": x, "y": y, "z": z}

    return (rescale(G.encode_points(pts_p)), rescale(G.encode_points(pts_q)),
            pts_p, pts_q, og)


def g1_inputs(ctx, lanes, rng):
    from kzg_tpu_torch.refmodel.model import G1
    return point_inputs(ctx, ctx.g1, G1(ctx.cp), 48, lanes, rng)


def g2_inputs(ctx, lanes, rng):
    from kzg_tpu_torch.refmodel.model import G2
    return point_inputs(ctx, ctx.g2, G2(ctx.cp), 16, lanes, rng)


def same_points(G, A, B, what, name, errs):
    """Exact equality of two point batches as canonical affine points;
    returns the packed array."""
    pa, pb = G.affine_packed(A), G.affine_packed(B)
    err = (pa - pb).abs().max().item() if pa.numel() else 0
    errs[name] = max(errs[name], err)
    check(err == 0, f"{what}: kernel != plain (max {err})")
    return pa


def p_of(G):
    """The base field's modulus of group G."""
    return G.F.base.modulus if G.is_fp2 else G.F.modulus


def fresh_points(G, A, what):
    """Kernel output coordinates: exact 16-bit limbs, each component
    < 1.1 p (first 64 lanes by value)."""
    from kzg_tpu_torch.fields.mont import limbs_to_ints
    p = p_of(G)
    for k in ("x", "y", "z"):
        check(int(A[k].max()) <= 0xFFFF, f"{what}: limbs above 16 bits")
        comps = [A[k][0], A[k][1]] if G.is_fp2 else [A[k]]
        for c in comps:
            v = max(limbs_to_ints(c.reshape(c.shape[0], -1)[:, :64]))
            check(v < p * 11 // 10, f"{what}: value >= 1.1p")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def kernel_name(mangled):
    """The name of a kernel from its mangled name (namespace dropped, an
    integer template argument kept): _ZN3kzg19g2_add_split_kernelILi16EE...
    -> g2_add_split_kernel<16>."""
    rest = mangled[2:].removeprefix("N")
    name = ""
    while (m := re.match(r"\d+", rest)):
        n = int(m.group())
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    arg = re.match(r"ILi(\d+)E", rest)
    return name + (f"<{arg.group(1)}>" if arg else "")


def ptxas_lines(log):
    """nvcc's ptxas report in a build's log: each kernel's name before its
    stack, spill and register lines."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Function properties for (_Z\w+)", ln)
        if m:
            out.append(kernel_name(m.group(1)))
        elif "registers" in ln or "spill" in ln or "stack" in ln:
            out.append(ln.strip())
    return out


def phase_build():
    from kzg_tpu_torch.ops import cuda
    t0 = time.time()
    secs = cuda.build(limbs=cuda.LIMBS)
    card = smi()
    for L in cuda.LIMBS:
        for name in cuda.SOURCES:
            for ln in ptxas_lines(cuda.build_log(name, L)):
                print(f"[build] {cuda.kernel_key(name, L)}: {ln}")
    line("build", t0, "nvcc sm_90a built in parallel, seconds to each "
         f"finish: { {k: round(v, 1) for k, v in secs.items()} }; card: "
         f"{card}")
    return card


def split_fit(dev, errs):
    """The fixed cost of a split launch: K3 and K5 at each limb count of
    FIT_LIMBS on the split executor (the shipped layout, the wrapper with
    team=True) at 1 lane, times = FIT_TIMES; each held exactly against the
    plain chain, then timed (kernel_ms, the median of three); per kernel
    the ms per times and the least-squares intercept and slope (ms a
    doubling)."""
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda, team
    out = {}
    for L in FIT_LIMBS:
        ctx = get_context({25: BLS, 11: BN158}[L], dev)
        for grp, G, inputs, dbl in (("g1", ctx.g1, g1_inputs, cuda.g1_dbl),
                                    ("g2", ctx.g2, g2_inputs, cuda.g2_dbl)):
            name = cuda.kernel_key(f"{grp}_dbl", L)
            P = tiled(inputs(ctx, 8, random.Random(SEED))[0], 1)
            ms = {}
            for times in FIT_TIMES:
                R = P
                for _ in range(times):
                    R = G._dbl_plain(R)
                same_points(G, dbl(G, P, times, team=True), R,
                            f"{name} split at 1 x {times}", name + " split",
                            errs)
                ms[times] = statistics.median(
                    kernel_ms(lambda: dbl(G, P, times, team=True))
                    for _ in range(3))
            slope, icpt = statistics.linear_regression(list(ms),
                                                       list(ms.values()))
            out[name] = {"layout": team.SPLIT_LAYOUT[grp][L][1], "ms": ms,
                         "intercept_ms": icpt, "slope_ms": slope}
    return out


def phase_split_fit(dev, card, errs):
    t0 = time.time()
    fit = split_fit(dev, errs)
    print(json.dumps({"split_fit": fit, "card": card}), flush=True)
    line("split_fit", t0, f"K3, K5 split at 1 lane, times {FIT_TIMES}, "
         "exact; intercept / slope ms: " + ", ".join(
             f"{k} {v['intercept_ms']:.4f} / {v['slope_ms']:.4f}"
             for k, v in fit.items()))


def k1_entry(curve, F):
    """The kernel line's entry of K1 on field F of `curve`."""
    from kzg_tpu_torch.ops import cuda
    if curve == BLS and F.L == cuda.BASE_L:
        return "mont_mul (BLS12-381 Fr)"
    return cuda.kernel_key("mont_mul", F.L)


def wide_operands(curve, F, lanes, rng):
    """(L, lanes) limbs of the widest product inputs that the point
    formulas give K1's field F of `curve`. BLS12-381 Fp: the G1 add's G =
    3b (X1Z2 + X2Z1) = 12 t5, t5 < 248 p with exact limbs, times a value
    below 248 p: a up to ~2976 p with limbs up to 12 x 65535 = 786,420, a b
    up to ~1.15 R p. BN158 Fp: half the lanes the G1 add's t3 M (exact
    limbs, each below ~186 p), half the G2 doubling's Karatsuba sums of
    qnr = 5 products, 8 (v0 + 5 v1 + v) times (v0 + 5 v1 + v) with fresh
    v's (limbs up to 56 x 65535, ~56 p times ~7 p)."""
    from kzg_tpu_torch.fields.mont import ints_to_limbs
    p = F.modulus

    def limbs(vals, scale=1):
        return scale * ints_to_limbs(vals, F.L).astype("int64")

    def fresh(n):
        return [rng.randrange(p) for _ in range(n)]

    if curve == BLS:
        a = limbs([rng.randrange(246 * p, 248 * p) for _ in range(lanes)],
                  12)
        b = limbs([rng.randrange(246 * p, 248 * p) for _ in range(lanes)])
    else:
        h = lanes // 2
        a = limbs([rng.randrange(184 * p, 186 * p) for _ in range(h)])
        b = limbs([rng.randrange(184 * p, 186 * p) for _ in range(h)])
        k = lanes - h
        sa = limbs(fresh(k)) + 5 * limbs(fresh(k)) + limbs(fresh(k))
        sb = limbs(fresh(k)) + 5 * limbs(fresh(k)) + limbs(fresh(k))
        a = torch.cat([torch.from_numpy(a), 8 * torch.from_numpy(sa)], 1)
        b = torch.cat([torch.from_numpy(b), torch.from_numpy(sb)], 1)
    return torch.as_tensor(a).to(F.device), torch.as_tensor(b).to(F.device)


def k1_widths(L):
    """The widths at which both K1 variants are held at L limbs: the
    team's ragged edges under the shipped layout (1, T - 1, T + 1 lanes,
    one lane past a block), the pairing's 108 and 216, the NTT's 4096,
    either side of the width rule and K1_LANES."""
    from kzg_tpu_torch.ops import cuda, k1_team
    T = k1_team.LAYOUT[L][0]
    lpb = k1_team.lanes_per_block(cuda.k1_table(L))
    below = cuda.K1_TEAM_BELOW[L]
    return sorted({1, max(T - 1, 1), T + 1, lpb + 1, 108, 216, 4096,
                   below - 1, below, *K1_LANES})


def k1_variants(curve, F, gen, rng, errs, wide):
    """K1's lane-team and thread-per-lane variants on field F of `curve`,
    each exact against Field._mul_plain at k1_widths, on lazy inputs up to
    2^22 limbs and, where `wide` (BLS12-381's and BN158's Fp), the last
    min(64, n / 2) lanes of each width at the point formulas' widest
    operands."""
    from kzg_tpu_torch.ops import cuda
    t0 = time.time()
    name = k1_entry(curve, F)
    widths = k1_widths(F.L)
    n = max(widths)
    a0, b0 = lazy_limbs(F, n, gen), lazy_limbs(F, n, gen)
    if wide:
        a0[:, -64:], b0[:, -64:] = wide_operands(curve, F, 64, rng)
    for w in widths:
        k = min(w // 2, 64) if wide else 0
        sl = torch.cat([torch.arange(w - k), torch.arange(n - k, n)])
        a = a0[:, sl.to(F.device)].contiguous()
        b = b0[:, sl.to(F.device)].contiguous()
        want = F._mul_plain(a, b)
        for team in (True, False):
            got = cuda.mont_mul(F, a, b, team=team)
            err = (got - want).abs().max().item()
            errs[name] = max(errs[name], err)
            check(err == 0, f"K1 {name} team={team} lanes={w}: kernel != "
                  f"plain (max {err})")
            check(int(got.max()) <= 0xFFFF, "K1 output limbs above 16 bits")
    line("kernels", t0, f"{curve} K1 {name}: the lane-team and the "
         f"thread-per-lane variants == plain (bit-exact limbs) at {widths} "
         "lanes" + (", up to 64 lanes a width at the widest operands"
                    if wide else ""))


# the least largest product input (in p) that the checked adds of 8200
# lanes must reach on the add's schedule, per curve and group: the G1 adds'
# lifts (lift_limbs(16): 180 p, 247 p, 185 p; BLS12-381's 12 t5 ~2976 p)
# and the G2 adds' Karatsuba sums
WIDEST = {("BN254", "g1"): 1000, ("BN254", "g2"): 25,
          (BLS, "g1"): 2900, (BLS, "g2"): 25,
          (BN158, "g1"): 180, (BN158, "g2"): 25}


def phase_kernels(dev, errs, curve="BN254"):
    """Each kernel against its plain version on the same card tensors, on
    `curve`'s fields and groups."""
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda, team
    from kzg_tpu_torch.ops.msm import MSMEngine
    ctx = get_context(curve, dev)
    seed = SEED + {"BN254": 0, BLS: 7, BN158: 9}[curve]
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = random.Random(seed)
    L = ctx.fp.L

    # K1 ---------------------------------------------------------------
    t0 = time.time()
    for F in (ctx.fp, ctx.fr):
        p = F.modulus
        R = 1 << (16 * F.L)
        rinv = pow(R, -1, p)
        name = k1_entry(curve, F)
        for lanes in K1_LANES:
            a = lazy_limbs(F, lanes, gen)
            b = lazy_limbs(F, lanes, gen)
            wide = 0
            if curve != "BN254" and F is ctx.fp:  # the point formulas' widest
                wide = 64
                a[:, -wide:], b[:, -wide:] = wide_operands(curve, F, wide,
                                                           rng)
            k = cuda.mont_mul(F, a, b)
            ref = F._mul_plain(a, b)
            sync()
            err = (k - ref).abs().max().item()
            errs[name] = max(errs[name], err)
            check(err == 0, f"K1 {name} lanes={lanes}: kernel != plain "
                  f"(max {err})")
            check(int(k.max()) <= 0xFFFF, "K1 output limbs above 16 bits")
            ck, cr = F.canon(k), F.canon(ref)
            check(torch.equal(ck, cr), f"K1 lanes={lanes}: canon mismatch")
            kh, ah, bh = k.cpu(), a.cpu(), b.cpu()
            lanes_checked = [0, 1, 2] + rng.sample(range(lanes - wide), 125)
            for i in lanes_checked + list(range(lanes - wide, lanes)):
                va, vb, vk = to_int(ah[:, i]), to_int(bh[:, i]), \
                    to_int(kh[:, i])
                check(vk * R < va * vb + R * p, f"K1 lane {i}: value >= "
                      "a b / R + p")
                check(i >= lanes - wide or vk < p + p // 10,
                      f"K1 lane {i}: value >= 1.1p")
                check(vk % p == va * vb * rinv % p,
                      f"K1 lane {i}: not a*b*R^-1 mod p")
    line("kernels", t0, f"{curve} K1 mont_mul (Fp: {k1_entry(curve, ctx.fp)}"
         f", Fr: {k1_entry(curve, ctx.fr)}) == plain (bit-exact limbs, "
         f"canonical values, 128 lanes vs python ints) at {K1_LANES} lanes, "
         "lazy inputs up to 2^22 limbs"
         + ("" if curve == "BN254" else ", 64 lanes per width at the point "
            "formulas' widest operands (output < a b / R + p)"))
    for F in (ctx.fp, ctx.fr):
        k1_variants(curve, F, gen, rng, errs,
                    wide=curve != "BN254" and F is ctx.fp)

    # K2 / K3 and K4 / K5 ------------------------------------------------
    lanes = K23_LANES
    for G, inputs, add, dbl, grp in (
            (ctx.g1, g1_inputs, cuda.g1_add, cuda.g1_dbl, "g1"),
            (ctx.g2, g2_inputs, cuda.g2_add, cuda.g2_dbl, "g2")):
        kadd = cuda.kernel_key(f"{grp}_add", L)
        kdbl = cuda.kernel_key(f"{grp}_dbl", L)
        t0 = time.time()
        P, Q, pts_p, pts_q, og = inputs(ctx, lanes, rng)
        sample = rng.sample(range(lanes), 16) + list(range(8))
        summed = G._add_plain(P, Q)
        mask = torch.rand(lanes, generator=gen, device=dev) < 0.3
        chains = {}
        for times in (1, 8):
            chains[times] = P
            for _ in range(times):
                chains[times] = G._dbl_plain(chains[times])
        vadd = point_variants(f"{grp}_add", L)
        vdbl = point_variants(f"{grp}_dbl", L)
        limbs = collections.defaultdict(list)   # each executor's outputs
        for forced in vadd:            # both executors under a width rule
            kw = team_kw(forced)
            v = "" if forced is None else f" team={forced}"
            k = add(G, P, Q, **kw)
            limbs[kadd, forced].append(k)
            fresh_points(G, k, kadd + v)
            got = G.unpack_affine(same_points(G, k, summed, kadd + v, kadd,
                                              errs))
            for i in sample:
                check(got[i] == og.add(pts_p[i], pts_q[i]),
                      f"{kadd}{v} lane {i} vs oracle")
            k = add(G, P, Q, mask, **kw)
            limbs[kadd, forced].append(k)
            fresh_points(G, k, f"{kadd}{v} reset")
            same_points(G, k, G.select(mask, Q, summed),
                        f"{kadd}{v} reset mask", kadd, errs)
        for forced in vdbl:
            kw = team_kw(forced)
            v = "" if forced is None else f" team={forced}"
            for times in (1, 8):
                k = dbl(G, P, times, **kw)
                limbs[kdbl, forced].append(k)
                fresh_points(G, k, kdbl + v)
                got = G.unpack_affine(same_points(
                    G, k, chains[times], f"{kdbl}{v} times={times}", kdbl,
                    errs))
                for i in sample:
                    check(got[i] == og.mul(1 << times, pts_p[i]),
                          f"{kdbl}{v} times={times} lane {i} vs oracle")
        for kname in (kadd, kdbl):     # the two executors, limb for limb
            if (kname, True) in limbs:
                check(all(torch.equal(a[c], b[c])
                          for a, b in zip(limbs[kname, True],
                                          limbs[kname, False])
                          for c in ("x", "y", "z")),
                      f"{kname}: the split executor's limbs != the lane "
                      "executor's")
        # the largest product inputs of the add's schedule on these lanes,
        # on the split executor's leveling too (its model: team.run with
        # the split product), which must give the same
        P64, Q64 = [{c: v[..., :64] for c, v in X.items()} for X in (P, Q)]
        stats = {}
        team.plain_add(G, P64, Q64, stats=stats)
        if len(vadd) == 2:
            split_stats = {}
            team.plain_add(G, P64, Q64, blk=team.split_block(G),
                           stats=split_stats)
            check(split_stats == stats, f"{kadd}: the split schedule's "
                  "product inputs differ from the lane schedule's")
        p = p_of(G)
        check(stats["value"] > WIDEST[curve, grp] * p,
              f"{kadd}: the checked adds miss the widest operands")
        widest = (f"; the add's product inputs reach "
                  f"{stats['value'] / p:.1f} p, limbs {stats['limb']}, a b "
                  f"= {stats['ab'] / (p << (16 * L)):.4f} R p")
        line("kernels", t0, f"{kadd} (with/without reset mask)"
             f"{both_executors(vadd)} and {kdbl} (times 1, 8)"
             f"{both_executors(vdbl)} == plain as canonical affine points "
             + ("(split limbs == lane limbs) " if len(vadd) == 2 else "") +
             f"over {lanes} lanes incl. infinity/doubling/negation; outputs "
             f"exact 16-bit, < 1.1p; 24 lanes vs oracle{widest}")
        edge_widths(G, P, Q, pts_p, pts_q, og, gen, errs)

        # K6 on the same group: aR, bL = P, Q; aL, bR a second pair
        t0 = time.time()
        name = cuda.kernel_key(f"merge_combine_{grp}", L)
        aL, bR, _, _, _ = inputs(ctx, lanes, rng)
        masks = [torch.rand(lanes, generator=gen, device=dev) < 0.5
                 for _ in range(3)]
        eng = MSMEngine(G, ctx.fr, ctx.cp.r, strategy="merge")
        k = cuda.merge_combine(G, aL, P, Q, bR, *masks)
        ref = eng._combine_plain(aL, P, Q, bR, *masks)
        for a, b, what in zip(k, ref, ("mid", "newL", "newR")):
            same_points(G, a, b, f"{name} {what}", name, errs)
        fresh_points(G, k[0], f"{name} mid")
        fuse, asing, bsing = masks
        for out, src, sel in ((k[1], aL, asing & fuse),
                              (k[2], bR, bsing & fuse)):
            for c in ("x", "y", "z"):
                check(torch.equal(out[c][..., ~sel], src[c][..., ~sel]),
                      f"{name}: a kept lane's limbs changed")
        hv, single = halves(aL, P, Q, bR, masks[1:], (8, lanes // 8))
        kh = cuda.merge_combine(G, *hv, masks[0].reshape(8, lanes // 8),
                                single[:, 0::2], single[:, 1::2])
        for a, b in zip(kh, k):
            for c in ("x", "y", "z"):
                check(torch.equal(a[c].reshape(b[c].shape), b[c]),
                      f"{name}: stride-2 halves != contiguous inputs")
        line("kernels", t0, f"{name} == plain (MSMEngine._combine_plain) as "
             f"canonical affine points over {lanes} lanes with random masks; "
             "kept lanes' limbs unchanged, mid exact 16-bit, < 1.1p; the "
             f"stride-2 halves of interleaved sums (8 x {lanes // 4}) give "
             "the same limbs as contiguous inputs")
        merge_edge_widths(G, aL, P, Q, bR, errs)


def edge_widths(G, P, Q, pts_p, pts_q, og, gen, errs):
    """The add and doubling-chain kernels of G's group (K2/K3 or K4/K5) at
    the ragged widths of their lane teams: the first n lanes of the
    K23_LANES batch (lane 0 doubles, lane 1 negates, lanes 2-4 hold
    infinity), with and without the reset mask, times 1 and 8; exact
    against the plain version, outputs fresh, the first 8 lanes against the
    oracle."""
    from kzg_tpu_torch.ops import cuda
    t0 = time.time()
    grp = "g2" if G.is_fp2 else "g1"
    add, dbl = getattr(cuda, f"{grp}_add"), getattr(cuda, f"{grp}_dbl")
    L = G.F.base.L if G.is_fp2 else G.F.L
    kadd = cuda.kernel_key(f"{grp}_add", L)
    kdbl = cuda.kernel_key(f"{grp}_dbl", L)
    vadd = point_variants(f"{grp}_add", L)
    vdbl = point_variants(f"{grp}_dbl", L)
    for n in EDGE_LANES:
        Pn = {k: v[..., :n].contiguous() for k, v in P.items()}
        Qn = {k: v[..., :n].contiguous() for k, v in Q.items()}
        summed = G._add_plain(Pn, Qn)
        mask = torch.rand(n, generator=gen, device=P["x"].device) < 0.5
        chains = {}
        for times in (1, 8):
            chains[times] = Pn
            for _ in range(times):
                chains[times] = G._dbl_plain(chains[times])
        for forced in vadd:
            kw = team_kw(forced)
            v = "" if forced is None else f" team={forced}"
            what = f"{kadd}{v} lanes={n}"
            k = add(G, Pn, Qn, **kw)
            fresh_points(G, k, what)
            got = G.unpack_affine(same_points(G, k, summed, what, kadd,
                                              errs))
            for i in range(min(n, 8)):
                check(got[i] == og.add(pts_p[i], pts_q[i]), f"{what} lane "
                      f"{i} vs oracle")
            k = add(G, Pn, Qn, mask, **kw)
            fresh_points(G, k, f"{what} reset")
            same_points(G, k, G.select(mask, Qn, summed),
                        f"{what} reset mask", kadd, errs)
        for forced in vdbl:
            kw = team_kw(forced)
            v = "" if forced is None else f" team={forced}"
            for times in (1, 8):
                what = f"{kdbl}{v} lanes={n} times={times}"
                k = dbl(G, Pn, times, **kw)
                fresh_points(G, k, what)
                got = G.unpack_affine(same_points(G, k, chains[times], what,
                                                  kdbl, errs))
                for i in range(min(n, 8)):
                    check(got[i] == og.mul(1 << times, pts_p[i]),
                          f"{what} lane {i} vs oracle")
    line("kernels", t0, f"{kadd} (with/without reset mask)"
         f"{both_executors(vadd)} and {kdbl} (times 1, 8)"
         f"{both_executors(vdbl)} == plain at edge widths {EDGE_LANES} "
         "lanes; outputs exact 16-bit, < 1.1p; first 8 lanes vs oracle")


def halves(aL, aR, bL, bR, sing, batch):
    """The operands of a merge level as _bucket_sums_merge gives them: the
    even and odd lanes (stride-2 views) of sumL = aL | bL and sumR = aR |
    bR interleaved over the batch shape `batch` (the lanes reshaped), and
    asing, bsing as the halves of one interleaved mask. Returns the four
    point views and the interleaved mask (the views are its [..., 0::2]
    and [..., 1::2])."""
    def inter(A, B):
        return torch.stack([A, B], dim=-1).reshape(
            A.shape[:-1] + batch[:-1] + (2 * batch[-1],))

    sL = {k: inter(aL[k], bL[k]) for k in aL}
    sR = {k: inter(aR[k], bR[k]) for k in aR}
    views = [{k: v[..., j::2] for k, v in S.items()}
             for S, j in ((sL, 0), (sR, 0), (sL, 1), (sR, 1))]
    return views, inter(*sing)


def merge_edge_widths(G, aL, aR, bL, bR, errs):
    """K6 at the ragged widths of its lane teams (the first n lanes of the
    K23_LANES batches), under each of the 8 uniform patterns of (fuse,
    asing, bsing) and the mixed pattern i % 8: mid equals the plain add
    as canonical affine points and its limbs are the same under every
    pattern; newL and newR equal the plain select of the kernel's own mid,
    limb for limb."""
    from kzg_tpu_torch.ops import cuda
    t0 = time.time()
    L = G.F.base.L if G.is_fp2 else G.F.L
    name = cuda.kernel_key("merge_combine_g2" if G.is_fp2
                           else "merge_combine_g1", L)
    dev = aR["x"].device
    for n in EDGE_LANES:
        ops = [{k: v[..., :n].contiguous() for k, v in X.items()}
               for X in (aL, aR, bL, bR)]
        bits = torch.arange(n, device=dev) % 8
        pats = [torch.full((n,), p, device=dev) for p in range(8)] + [bits]
        mid0 = None
        for pat in pats:
            fuse, asing, bsing = [(pat >> b) & 1 == 1 for b in range(3)]
            mid, newL, newR = cuda.merge_combine(G, *ops, fuse, asing, bsing)
            if mid0 is None:
                mid0 = mid
                same_points(G, mid, G._add_plain(ops[1], ops[2]),
                            f"{name} lanes={n} mid", name, errs)
                fresh_points(G, mid, f"{name} lanes={n} mid")
            for c in ("x", "y", "z"):
                check(torch.equal(mid[c], mid0[c]), f"{name} lanes={n}: mid "
                      "differs between mask patterns")
            for out, src, sel in ((newL, ops[0], fuse & asing),
                                  (newR, ops[3], fuse & bsing)):
                want = G.select(sel, mid, src)
                for c in ("x", "y", "z"):
                    check(torch.equal(out[c], want[c]), f"{name} lanes={n}: "
                          "newL/newR != select of mid")
    line("kernels", t0, f"{name} == plain at edge widths {EDGE_LANES} lanes "
         "under all 8 uniform mask patterns and i % 8; mid exact 16-bit, "
         "< 1.1p")


def phase_golden(dev, curve="BN254"):
    import kzg_tpu_torch as kzg
    t0 = time.time()
    gold = os.path.join(HERE, "tests", "fixtures", "golden")
    with open(os.path.join(gold, f"golden_{curve}.json")) as f:
        vec = json.load(f)
    kzg.init(curve, device=dev)
    ts = kzg.trusted_setup(os.path.join(gold, vec["setup_file"]))
    msg = vec["message"]
    p = kzg.poly.from_blob(kzg.blob.from_string(msg))
    check(p.serialize().hex() == vec["poly_hex"], "golden poly bytes")
    c = ts.create_commit(p)
    check(c.serialize().hex() == vec["commit_hex"], "golden commit bytes")
    for pr in vec["proofs"]:
        got = ts.create_proof(p, pr["chunk_offset"], pr["chunk_length"])
        check(got.serialize().hex() == pr["proof_hex"],
              f"golden proof bytes {pr['chunk_offset']},{pr['chunk_length']}")
    off, ln = vec["proofs"][-1]["chunk_offset"], vec["proofs"][-1][
        "chunk_length"]
    check(ts.verify_proof(c, got, kzg.blob.from_string(msg[off:off + ln],
                                                       off)),
          "golden whole-message proof verifies")
    bad = msg[:5] + chr(ord(msg[5]) ^ 1) + msg[6:]
    check(not ts.verify_proof(c, got, kzg.blob.from_string(
        bad[off:off + ln], off)), "golden refutation")
    line("golden", t0, f"{curve} golden poly/commit/{len(vec['proofs'])} "
         "proof bytes reproduced from the 48-term file; verify true, "
         "refutation false")


def poly_at(coeffs, x, r):
    """A polynomial's value at x mod r (python ints, Horner)."""
    v = 0
    for c in reversed(coeffs):
        v = (v * x + c) % r
    return v


def oracle_commit(og, r, coeffs, s):
    """The commitment of a setup made from secret s: the s-power MSM of the
    coefficients, [p(s)] G1 (python ints)."""
    return og.mul(poly_at(coeffs, s, r), og.gen)


def oracle_proof(og, r, coeffs, off, ln, s):
    """The proof of points off .. off + ln - 1 under a setup made from s:
    [q(s)] G1 with q = (p - I) / Z, I the interpolant of p at the points and
    Z their vanishing polynomial, so q(s) = (p(s) - I(s)) / Z(s)."""
    xs = [(off + i) % r for i in range(ln)]
    at_s = 0
    for j, xj in enumerate(xs):
        num = den = 1
        for k, xk in enumerate(xs):
            if k != j:
                num, den = num * (s - xk) % r, den * (xj - xk) % r
        at_s += poly_at(coeffs, xj, r) * num * pow(den, -1, r)
    z = math.prod(s - x for x in xs) % r
    q = (poly_at(coeffs, s, r) - at_s) * pow(z, -1, r) % r
    return og.mul(q, og.gen)


def check_oracle(pc, s, data, p, c, proofs, what):
    """from_blob, the commitment and the proofs {(off, ln): proof} of a
    setup made from secret s against python-int arithmetic: p(i) = the i-th
    character at 16 points (all where the message is shorter), [p(s)] G1
    and [q(s)] G1."""
    from kzg_tpu_torch.refmodel.model import G1
    og, r = G1(pc.cp), pc.cp.r
    coeffs = p.coeffs
    check(len(coeffs) <= len(data), f"{what}: from_blob degree")
    at = range(len(data)) if len(data) <= 16 else \
        random.Random(len(data)).sample(range(len(data)), 16)
    check(all(poly_at(coeffs, i, r) == ord(data[i]) for i in at),
          f"{what}: from_blob's polynomial misses the message")
    check(c.curve_point == oracle_commit(og, r, coeffs, s),
          f"{what}: commitment != the oracle's [p(s)] G1")
    for (off, ln), pr in proofs.items():
        check(pr.curve_point == oracle_proof(og, r, coeffs, off, ln, s),
              f"{what}: proof ({off}, {ln}) != the oracle's [q(s)] G1")


def phase_oracle(dev, curve=BN158):
    """`curve` without a golden file: an 8-term setup from a known secret
    on the card; from_blob("curves!"), the commitment and the proofs of (1,
    3) and (0, 1) equal the python-int oracle's; the first verifies, a
    changed byte is refuted."""
    import kzg_tpu_torch as kzg
    t0 = time.time()
    pc = kzg.init(curve, device=dev)
    s, msg = 0xC0FFEE_1234_5678_9ABC_DEF0, "curves!"
    ts = kzg.trusted_setup.from_secret(s, 8)
    p = kzg.poly.from_blob(kzg.blob.from_string(msg))
    c = ts.create_commit(p)
    proofs = {k: ts.create_proof(p, *k) for k in ((1, 3), (0, 1))}
    check_oracle(pc, s, msg, p, c, proofs, f"{curve} 8-term setup")
    check(ts.verify_proof(c, proofs[1, 3], kzg.blob.from_string(msg[1:4], 1)),
          f"{curve}: the proof of (1, 3) verifies")
    check(not ts.verify_proof(c, proofs[1, 3], kzg.blob.from_string("uzv", 1)),
          f"{curve}: a changed byte is refuted")
    line("golden", t0, f"{curve} 8-term setup from a known secret: "
         "from_blob('curves!'), commitment and proofs (1, 3), (0, 1) == the "
         "python-int oracle's [p(s)] G1, [q(s)] G1; verify true, refutation "
         "false")


def main_message():
    """bench.py's message: DEGREE + 1 printable characters."""
    rng = random.Random(1)
    return "".join(chr(rng.randrange(32, 127)) for _ in range(DEGREE + 1))


def phase_main(dev, card, curve="BN254"):
    """bench.py's path on `curve`; its JSON lines are main_path and profile
    on BN254, main_path_bls and profile_bls on BLS12-381, main_path_bn158
    and profile_bn158 on BN158."""
    import kzg_tpu_torch as kzg
    from kzg_tpu_torch.ops import cuda
    label, sfx = LABEL[curve]
    required = PATH_KERNELS[curve]
    pc = kzg.init(curve, device=dev)
    data = main_message()
    per_op = {}
    t_all = time.time()
    cuda.reset_counts()

    def step(name, fn):
        before = cuda.counts()
        t0 = time.time()
        out = fn()
        sync()
        ms = (time.time() - t0) * 1e3
        after = cuda.counts()
        per_op[name] = {k: after[k] - before[k] for k in after}
        return out, ms

    ts, setup_ms = step("setup", lambda: kzg.trusted_setup.from_secret(
        MAIN_SECRET, SETUP_TERMS))
    p, blob_ms = step("from_blob",
                      lambda: kzg.poly.from_blob(kzg.blob.from_string(data)))
    check(p._n == DEGREE + 1, "from_blob length")
    c, commit_cold = step("commit", lambda: ts.create_commit(p))
    pr, proof_cold = step("proof", lambda: ts.create_proof(p, 0, 1))
    good = kzg.blob.from_string(data[0], 0)
    ok, verify_cold = step("verify", lambda: ts.verify_proof(c, pr, good))
    check(ok is True, "main-path verify_proof is true")
    bad = kzg.blob.from_string(chr(ord(data[0]) ^ 1), 0)
    refuted, _ = step("refute", lambda: not ts.verify_proof(c, pr, bad))
    check(refuted, "main-path one-bit refutation is false")
    launches = cuda.counts()
    shapes = {k: dict(v.shapes) for k, v in cuda.KERNELS.items()}
    for name in required:
        check(launches[name] > 0, f"kernel {name} not launched on the "
              f"{label} path")
    check_oracle(pc, MAIN_SECRET, data, p, c, {(0, 1): pr}, label)
    line(label, t_all, f"{curve} setup({SETUP_TERMS}) {setup_ms:.0f} ms "
         f"incl. self-check, from_blob(deg {DEGREE}) {blob_ms:.0f} ms; "
         "commitment and proof == the oracle's [p(s)] G1, [q(s)] G1; verify "
         f"true, refutation false; launches {launches}")

    _, _, commit_ms = host_ms(lambda: ts.create_commit(p), WARM_RUNS)
    _, _, proof_ms = host_ms(lambda: ts.create_proof(p, 0, 1), WARM_RUNS)
    _, _, verify_ms = host_ms(lambda: ts.verify_proof(c, pr, good), WARM_RUNS)
    print(json.dumps({f"main_path{sfx}": {
        "card": card, "curve": curve, "setup_ms": setup_ms,
        "from_blob_ms": blob_ms,
        "commit_cold_ms": commit_cold, "commit_warm_median_ms": commit_ms,
        "proof_cold_ms": proof_cold, "proof_warm_median_ms": proof_ms,
        "verify_cold_ms": verify_cold, "verify_warm_median_ms": verify_ms,
        "warm_runs": WARM_RUNS, "launches_per_op": per_op}}), flush=True)
    prof = profile_ops({"from_blob": lambda: kzg.poly.from_blob(
                            kzg.blob.from_string(data)),
                        "commit": lambda: ts.create_commit(p),
                        "proof": lambda: ts.create_proof(p, 0, 1),
                        "verify": lambda: ts.verify_proof(c, pr, good)})
    print(json.dumps({f"profile{sfx}": {"card": card, **prof}}), flush=True)
    line(label, t_all, f"card {card}: commit cold {commit_cold:.1f} / warm "
         f"{commit_ms:.1f} ms, proof cold {proof_cold:.1f} / warm "
         f"{proof_ms:.1f} ms, verify cold {verify_cold:.1f} / warm "
         f"{verify_ms:.1f} ms (median of {WARM_RUNS})")
    return launches, shapes, (ts, p, c)


def phase_msm(card, main_state):
    """The merge strategy's path: msm over arbitrary bases (Horner over the
    windows) on the main phase's setup points and polynomial, on the curve
    that phase initialised; its JSON line is msm, msm_bls or msm_bn158. The
    counts are read around the merge msm calls alone (cold and warm runs);
    the references and decodes come after."""
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.ops.msm import MSMEngine
    from kzg_tpu_torch.protocol.api import _ctx
    ts, p, c = main_state
    pc = _ctx()
    ctx = pc.ctx
    label = "msm" + LABEL[ctx.cp.name][1]
    required = [cuda.kernel_key(f"merge_combine_{grp}", ctx.fp.L)
                for grp in ("g1", "g2")]
    r = ctx.cp.r
    n = MSM_POINTS
    sraw = pc.fr_raw(p.device_coeffs(pc))
    check(sraw.shape[-1] == n, f"msm: {sraw.shape[-1]} scalars, not {n}")
    t_all = time.time()

    def first(P, m):
        return {k: v[..., :m] for k, v in P.items()}

    def affine(G, P):
        return G.decode_points({k: v[..., None] for k, v in P.items()})[0]

    groups = (("g1", ctx.g1, ts._g1_points_dev()),
              ("g2", ctx.g2, ts._g2_points_dev()))
    res, outs = {}, {}
    cuda.reset_counts()
    for grp, G, pts in groups:
        eng = MSMEngine(G, ctx.fr, r, strategy="merge")
        P = first(pts, n)
        before = cuda.counts()
        outs[grp], cold, warm = host_ms(lambda: eng.msm(sraw, P), WARM_RUNS)
        after = cuda.counts()
        res[grp] = {"points": n, "cold_ms": cold, "warm_median_ms": warm,
                    "launches_per_call": {
                        k: (after[k] - before[k]) // (WARM_RUNS + 1)
                        for k in after}}
    launches = cuda.counts()
    shapes = {k: dict(v.shapes) for k, v in cuda.KERNELS.items()}
    for name in required:
        check(launches[name] > 0, f"kernel {name} not launched on the "
              f"{label} path")
    check(affine(ctx.g1, outs["g1"]) == c.curve_point,
          f"msm g1 merge over {n} points != the commitment")
    want2 = affine(ctx.g2, ctx.msm_g2.msm_shifted(
        sraw, first(ts._shifted2(), n)))
    check(affine(ctx.g2, outs["g2"]) == want2 and want2 is not None,
          f"msm g2 merge over {n} points != chunked msm_shifted")
    m = MSM_SCAN_POINTS
    want = affine(ctx.g1, ctx.msm_g1.msm_shifted(
        sraw[..., :m], first(ts._shifted1(), m)))
    for strategy in ("log", "scan"):
        eng = MSMEngine(ctx.g1, ctx.fr, r, strategy=strategy)
        out, cold, _ = host_ms(
            lambda: eng.msm(sraw[..., :m], first(ts._g1_points_dev(), m)), 0)
        check(affine(ctx.g1, out) == want,
              f"msm g1 {strategy} over {m} points != chunked msm_shifted")
        res[f"g1_{strategy}"] = {"points": m, "cold_ms": cold}
    prof = profile_ops({
        f"merge_{grp}": (lambda eng=MSMEngine(G, ctx.fr, r, strategy="merge"),
                         P=first(pts, n): eng.msm(sraw, P))
        for grp, G, pts in groups})
    print(json.dumps({label: {"card": card, "curve": ctx.cp.name,
                              "warm_runs": WARM_RUNS, **res,
                              "profile": prof}}), flush=True)
    line(label, t_all, f"{ctx.cp.name} merge msm over {n} points: G1 == "
         "commitment (cold "
         f"{res['g1']['cold_ms']:.1f} / warm {res['g1']['warm_median_ms']:.1f}"
         f" ms), G2 == chunked (cold {res['g2']['cold_ms']:.1f} / warm "
         f"{res['g2']['warm_median_ms']:.1f} ms); log and scan over {m} "
         f"points == chunked; launches {launches}")
    return launches, shapes


# ----------------------------------------------------------------------
# step 3 of the port: the CLI, the demo, proofs above MULTIEVAL_DIRECT
# points and the multi-device paths
# ----------------------------------------------------------------------

def interp_at(ys, off, x, r):
    """I(x) of the unique I with I(off + i) = ys[i] for i < k (python ints):
    the barycentric form over consecutive points, O(k):
    I(x) = Z(x) sum_i ys[i] w_i / (x - off - i), with Z the points'
    vanishing polynomial and w_i = (-1)^(k-1-i) / (i! (k-1-i)!)."""
    k = len(ys)
    fact = [1] * k
    for i in range(1, k):
        fact[i] = fact[i - 1] * i % r
    diffs = [(x - off - i) % r for i in range(k)]
    if 0 in diffs:
        return ys[diffs.index(0)] % r
    tot = 0
    for i, y in enumerate(ys):
        d = fact[i] * fact[k - 1 - i] * diffs[i] % r
        t = y * pow(d, -1, r)
        tot += -t if (k - 1 - i) % 2 else t
    return math.prod(diffs) * tot % r


def proof_scalar(ps, ys, off, s, r):
    """q(s) of the proof of the points off .. off + k - 1 with values ys,
    given p(s): (p(s) - I(s)) / Z(s), O(k)."""
    z = math.prod(s - off - i for i in range(len(ys))) % r
    return (ps - interp_at(ys, off, s, r)) * pow(z, -1, r) % r


def chunks_of(data, size):
    """The blob scalars of `data`: little-endian chunks of `size` bytes."""
    return [int.from_bytes(data[i:i + size], "little")
            for i in range(0, len(data), size)]


def run_cli(argv, cwd, dev):
    """kzg_tpu_torch.cli.main in-process in `cwd` (the working directory
    restored after): (exit code, stdout, wall ms, launches by kernel)."""
    import contextlib
    import io

    from kzg_tpu_torch import cli
    from kzg_tpu_torch.ops import cuda
    out = io.StringIO()
    old = os.getcwd()
    before = cuda.counts()
    os.chdir(cwd)
    try:
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv, device=dev)
        sync()
        ms = (time.time() - t0) * 1e3
    finally:
        os.chdir(old)
    after = cuda.counts()
    return rc, out.getvalue(), ms, {k: after[k] - before[k] for k in after
                                   if after[k] > before[k]}


def cli_round(tmp, dev, curve, data, seed, secret, refute):
    """commit, prove SEED and verify (exit 0) of `data` through the CLI on
    `curve`, against the setup from `secret` in tmp/shared, and where
    `refute` a flipped byte's verify (exit 1); the commitment and the proof
    held to the oracle's [p(s)] G1 and [q(s)] G1 (barycentric forms).
    Returns {command: {"ms", "launches"}}."""
    from kzg_tpu_torch.curves.params import get_curve
    from kzg_tpu_torch.protocol.serial import serialize_g1
    from kzg_tpu_torch.refmodel.model import G1
    cp = get_curve(curve)
    r, og = cp.r, G1(cp)
    peer = os.path.join(tmp, "peer")
    path = os.path.join(peer, "data.bin")
    with open(path, "wb") as f:
        f.write(data)
    flag = [] if curve == "BN254" else [f"--curve={curve}"]
    res = {}

    def cmd(name, *args):
        rc, out, ms, launches = run_cli(flag + [name, *args], peer, dev)
        res[name if name not in res else name + "_refute"] = {
            "ms": ms, "launches": launches}
        return rc, out

    # commit's chunks (CURVE_ORDER_BYTES - 1) and prove's (MAX_CHUNK_BYTES)
    # have one size
    size = cp.max_chunk_bytes
    padded = data + b"\x00" * (size - len(data) % size)
    ys = chunks_of(padded, size)
    ps = interp_at(ys, 0, secret, r)
    rc, out = cmd("commit", path)
    check(rc == 0 and out.strip() == serialize_g1(og.mul(ps, og.gen),
                                                  cp).hex(),
          f"cli {curve} commit != the oracle's [p(s)] G1")
    rc, out = cmd("prove", path, str(seed))
    proof_hex, off, data_hex = out.split()
    want_off = seed % (len(data) // size - 4)
    q = proof_scalar(ps, ys[want_off:want_off + 4], want_off, secret, r)
    check(rc == 0 and int(off) == want_off and
          proof_hex == serialize_g1(og.mul(q, og.gen), cp).hex() and
          data_hex == padded[want_off * size:(want_off + 4) * size].hex(),
          f"cli {curve} prove != the oracle's [q(s)] G1 at chunk {want_off}")
    commit_hex = serialize_g1(og.mul(ps, og.gen), cp).hex()
    rc, _ = cmd("verify", commit_hex, proof_hex, off, data_hex)
    check(rc == 0, f"cli {curve} verify exits {rc}, not 0")
    if not refute:
        return res
    bad = bytearray(bytes.fromhex(data_hex))
    bad[size + 2] ^= 1
    rc, _ = cmd("verify", commit_hex, proof_hex, off, bad.hex())
    check(rc == 1, f"cli {curve} verify of a flipped byte exits {rc}, not 1")
    return res


def phase_cli(dev, card, main_state):
    """The CLI (kzg_tpu_torch.cli, in-process, from a peer directory beside
    shared/): BN254 setup 5000 (timed, its export reloaded), then on the
    main path's from_secret setup commit, prove, verify and a flipped byte
    of a file of CLI_FILE_BYTES (4096 chunks when padded), held to the
    oracle; BLS12-381 and BN158 once each on the demo's document against a
    CLI_SMALL_TERMS-term setup from a known secret. Launches counted from 0
    over the phase (K1-K5 of BN254 must run) and per command."""
    import tempfile

    import kzg_tpu_torch as kzg
    from kzg_tpu_torch.ops import cuda
    ts_main = main_state[0]
    t_all = time.time()
    cuda.reset_counts()
    res = {"card": card}
    with tempfile.TemporaryDirectory(prefix="kzg_cli_") as tmp:
        shared = os.path.join(tmp, "shared")
        os.makedirs(shared)
        os.makedirs(os.path.join(tmp, "peer"))
        public = os.path.join(shared, "kzg_public")
        rc, out, ms, launches = run_cli(["setup", str(SETUP_TERMS)], shared,
                                        dev)
        check(rc == 0 and out.splitlines()[1] ==
              f"  num_coeff={SETUP_TERMS}", f"cli setup: {rc} {out!r}")
        t0 = time.time()
        kzg.init("BN254", device=dev)
        back = kzg.trusted_setup(public)
        check(back._n == SETUP_TERMS and len(back._g2) == SETUP_TERMS,
              "cli setup's export reloads with its length")
        res["setup"] = {"terms": SETUP_TERMS, "ms": ms, "launches": launches,
                        "reload_ms": (time.time() - t0) * 1e3}
        ts_main.export_setup(public)              # the main path's setup
        data = random.Random(SEED).randbytes(CLI_FILE_BYTES)
        res["BN254"] = cli_round(tmp, dev, "BN254", data, CLI_SEED,
                                 MAIN_SECRET, refute=True)
        res["BN254"]["file_bytes"] = CLI_FILE_BYTES
        with open(os.path.join(HERE, "demo", "peer-a", "document.txt"),
                  "rb") as f:
            doc = f.read()
        for curve in (BLS, BN158):
            kzg.init(curve, device=dev)
            kzg.trusted_setup.from_secret(CLI_SMALL_SECRET,
                                          CLI_SMALL_TERMS).export_setup(
                                              public)
            res[curve] = cli_round(tmp, dev, curve, doc, CLI_SEED,
                                   CLI_SMALL_SECRET, refute=False)
    launches = cuda.counts()
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} not launched on the cli "
              "path")
    print(json.dumps({"cli": res}), flush=True)
    b = res["BN254"]
    line("cli", t_all, f"card {card}: setup {SETUP_TERMS} "
         f"{res['setup']['ms']:.0f} ms (export reloads); BN254 on "
         f"{CLI_FILE_BYTES} bytes: commit {b['commit']['ms']:.0f} ms, prove "
         f"{b['prove']['ms']:.0f} ms == the oracle's, verify 0 "
         f"({b['verify']['ms']:.0f} ms), flipped byte 1; BLS12381 and BN158 "
         "on the demo's document == the oracle's, verify 0")


def phase_demo(dev, card):
    """kzg_tpu_torch.demo.run_demo() on the card: the demo's own sizes
    (SETUP_TERMS 512, its 264-byte document); every CLI call is a process of
    its own, so its launches are not counted here (the cli phase counts the
    same calls in-process). Its challenges are random, so first the pairing
    check of one demo storage proof whose Miller point ends with a lazy y
    past 8 p (DEMO_WIDE_Y) must hold on the card."""
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.curves.params import get_curve
    from kzg_tpu_torch.demo import run_demo
    from kzg_tpu_torch.pairing.engine import PairingEngine
    from kzg_tpu_torch.refmodel.model import G1, G2
    t0 = time.time()
    cp, ctx = get_curve("BN254"), get_context("BN254", device=dev)
    og1, og2 = G1(cp), G2(cp)
    a, b = DEMO_WIDE_Y

    def pt(G, P):
        return {k: v[..., 0] for k, v in G.encode_points([P]).items()}

    check(bool(PairingEngine(ctx).pairing_check(
        pt(ctx.g2, og2.mul(a, og2.gen)), pt(ctx.g1, og1.mul(b, og1.gen)),
        pt(ctx.g2, og2.gen), pt(ctx.g1, og1.mul(a * b % cp.r, og1.gen)))
        .item()), "demo: the pairing check at a Miller point's wide y")
    t1 = time.time()
    rc, out = run_demo(timeout=600)
    ms = (time.time() - t1) * 1e3
    tail = out.strip().splitlines()
    check(rc == 0, f"demo exits {rc}:\n{out[-3000:]}")
    check(tail and tail[-1] == "demo complete", "demo does not complete")
    check(out.count("storage proof VALID") == 2,
          "demo: both hours' storage proofs VALID")
    print(json.dumps({"demo": {"card": card, "wall_ms": ms,
                               "lines": len(tail)}}), flush=True)
    line("demo", t0, f"wide-y pairing check holds; run-demo exit 0 in "
         f"{ms:.0f} ms, both hours' storage proofs VALID, demo complete")


def phase_multiproof(card, main_state, data):
    """Proofs above MULTIEVAL_DIRECT points (the subproduct-tree branch of
    multieval) on the BN254 main phase's setup and polynomial: for k in
    MULTIPROOF_K, create_proof(p, 0, k) equals the oracle's [q(s)] G1
    (barycentric, checked against the O(k^2) form at small k) and verifies,
    and at the first k a flipped byte is refuted. Launches counted from 0
    over the phase (K1, K2 and K4 must run); returns (launches, shapes)."""
    import kzg_tpu_torch as kzg
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.ops.poly import MULTIEVAL_DIRECT
    from kzg_tpu_torch.refmodel.model import G1
    ts, p, c = main_state
    pc = ts._pc
    r, og = pc.cp.r, G1(pc.cp)
    check(min(MULTIPROOF_K) > MULTIEVAL_DIRECT, "multiproof: every k above "
          "MULTIEVAL_DIRECT")
    ys = [ord(ch) for ch in data]
    ps = interp_at(ys, 0, MAIN_SECRET, r)
    coeffs = p.coeffs
    check(ps == poly_at(coeffs, MAIN_SECRET, r), "multiproof: p(s)")
    for k in (1, 5):                           # the O(k) form == the O(k^2)
        check(og.mul(proof_scalar(ps, ys[3:3 + k], 3, MAIN_SECRET, r),
                     og.gen) == oracle_proof(og, r, coeffs, 3, k,
                                             MAIN_SECRET),
              f"multiproof: barycentric q(s) != the O(k^2) form at k={k}")
    t_all = time.time()
    cuda.reset_counts()
    res = {}
    for k in MULTIPROOF_K:
        before = cuda.counts()
        t0 = time.time()
        pr = ts.create_proof(p, 0, k)
        sync()
        prove_ms = (time.time() - t0) * 1e3
        t0 = time.time()
        ok = ts.verify_proof(c, pr, kzg.blob.from_string(data[:k], 0))
        verify_ms = (time.time() - t0) * 1e3
        after = cuda.counts()
        check(ok is True, f"multiproof k={k}: verify_proof is true")
        q = proof_scalar(ps, ys[:k], 0, MAIN_SECRET, r)
        check(pr.curve_point == og.mul(q, og.gen),
              f"multiproof k={k}: proof != the oracle's [q(s)] G1")
        res[k] = {"prove_ms": prove_ms, "verify_ms": verify_ms,
                  "launches": {n: after[n] - before[n] for n in after
                               if after[n] > before[n]}}
        if k == MULTIPROOF_K[0]:
            bad = data[:k // 2] + chr(ord(data[k // 2]) ^ 1) + data[k // 2 + 1:k]
            check(not ts.verify_proof(c, pr, kzg.blob.from_string(bad, 0)),
                  f"multiproof k={k}: a flipped byte is refuted")
    launches = cuda.counts()
    shapes = {n: dict(v.shapes) for n, v in cuda.KERNELS.items()}
    print(json.dumps({"multiproof": {"card": card, **res}}), flush=True)
    # the setup's shifted bases are built, so K3 and K5 do not run here
    for name in ("mont_mul", "g1_add", "g2_add"):
        check(launches[name] > 0, f"kernel {name} not launched on the "
              "multiproof path")
    line("multiproof", t_all, "BN254 create_proof(p, 0, k) == the oracle's "
         "[q(s)] G1 and verifies at k = " + ", ".join(
             f"{k} ({v['prove_ms']:.0f} / {v['verify_ms']:.0f} ms)"
             for k, v in res.items()) + f"; flipped byte refuted at k = "
         f"{MULTIPROOF_K[0]}")
    return launches, shapes


def mean_ms(fn, runs=NATIVE_RUNS):
    """(last result, mean host ms of `runs` calls) of host-only work."""
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / runs


def phase_native(dev, card, main_state):
    """The native codec library (kzg_tpu_torch/native.py over
    csrc/kzg_native.cpp, host C++): built with the machine's host compiler
    (timed), then every method held exactly against its plain python
    version at the main path's sizes: pack_chunks and pack_chunks_limbs of
    NATIVE_CHUNKS chunks of NATIVE_CHUNK bytes from a seeded buffer,
    be_to_limbs / limbs_to_be over the G1 and G2 coordinates of the BN254
    main setup's kzg_public bytes (serial.write_setup_file), poly_encode /
    poly_decode of the degree-4096 polynomial, hex of a proof; a short
    buffer raises in serial.pack_chunks, pack_chunks_limbs and
    blob.from_bytes; from_bytes -> from_blob (the limb matrix uploaded
    without python ints) gives the device coefficients of the ints path,
    each timed on the host ending in a synchronize; K1 must run there."""
    import tempfile

    import numpy as np

    import kzg_tpu_torch as kzg
    from kzg_tpu_torch import native
    from kzg_tpu_torch.fields.mont import ints_to_limbs, limbs_to_ints
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.protocol import serial
    ts, p, _ = main_state
    pc = kzg.init("BN254", device=dev)
    fr = pc.ctx.fr
    t_all = time.time()
    cxx = native._compiler()
    t0 = time.time()
    so = native.build()
    build_s = time.time() - t0
    lib = native.lib()
    check(lib.path == so and so.parent == native.BUILD_DIR,
          f"native: the library loads from {native.BUILD_DIR}")
    res = {"card": card, "compiler": " ".join(cxx), "build_s": build_s,
           "so": os.path.relpath(so, HERE)}

    def same(name, got, want, lib_ms, plain_ms):
        eq = np.array_equal(got, want) if isinstance(got, np.ndarray) \
            else got == want
        check(eq, f"native {name} != its plain version")
        res[name] = {"ms": lib_ms, "plain_ms": plain_ms, "equal": True}

    # chunk packing
    n, size = NATIVE_CHUNKS, NATIVE_CHUNK
    nl = (size + 1) // 2
    data = random.Random(SEED).randbytes(n * size)
    ints, plain_ms = mean_ms(lambda: serial.pack_chunks(data, n, size))
    got, ms = mean_ms(lambda: lib.pack_chunks(data, n, size))
    same("pack_chunks", got, ints, ms, plain_ms)
    want, plain_ms = mean_ms(lambda: ints_to_limbs(
        serial.pack_chunks(data, n, size), nl))
    got, ms = mean_ms(lambda: serial.pack_chunks_limbs(data, n, size, nl))
    same("pack_chunks_limbs", got, want, ms, plain_ms)
    for call in (lambda: serial.pack_chunks(data[:-1], n, size),
                 lambda: serial.pack_chunks_limbs(data[:-1], n, size, nl),
                 lambda: kzg.blob.from_bytes(data[:-1], 0, n * size, size)):
        try:
            call()
        except ValueError as e:
            check(str(e) == "buffer shorter than requested range",
                  f"native short buffer: {e}")
        else:
            check(False, "native: a short buffer does not raise")
    res["short_buffer_raises"] = True

    # setup records: the coordinates of kzg_public's G1 and G2 records
    cp = pc.cp
    w = cp.modbytes
    with tempfile.TemporaryDirectory(prefix="kzg_native_") as tmp:
        path = os.path.join(tmp, "kzg_public")
        serial.write_setup_file(path, ts._g1, ts._g2, cp)
        with open(path, "rb") as f:
            blob_bytes = f.read()
    terms = ts._n
    g1_len, g2_len = 5 + 2 * w, 5 + 4 * w
    rec = np.frombuffer(blob_bytes, np.uint8, offset=8)
    g1 = rec[:terms * g1_len].reshape(terms, g1_len)[:, 5:].tobytes()
    g2 = rec[terms * g1_len:].reshape(terms, g2_len)[:, 5:].tobytes()
    want_vals = {"g1": [v for pt in ts._g1 for v in pt],
                 "g2": [v for pt in ts._g2 for c in pt for v in c]}
    for name, coords in (("g1", g1), ("g2", g2)):
        k = len(coords) // w
        L = pc.ctx.fp.L

        def plain_limbs():
            return ints_to_limbs([int.from_bytes(coords[i * w:(i + 1) * w],
                                                 "big") for i in range(k)], L)
        want, plain_ms = mean_ms(plain_limbs)
        check(limbs_to_ints(want) == want_vals[name],
              f"native {name}: the records hold the setup's coordinates")
        mat, ms = mean_ms(lambda: lib.be_to_limbs(coords, k, w, L))
        same(f"be_to_limbs_{name}", mat, want, ms, plain_ms)
        vals = limbs_to_ints(mat)
        want, plain_ms = mean_ms(lambda: b"".join(
            v.to_bytes(w, "big") for v in vals))
        got, ms = mean_ms(lambda: lib.limbs_to_be(mat, w))
        same(f"limbs_to_be_{name}", got, want, ms, plain_ms)
        check(got == coords, f"native limbs_to_be_{name} != the records")
        res[f"be_to_limbs_{name}"]["records"] = k

    # the degree-4096 polynomial's stream
    coeffs = p.coeffs
    wr = cp.order_bytes
    rows = np.frombuffer(b"".join(v.to_bytes(wr, "little") for v in coeffs),
                         np.uint8).reshape(len(coeffs), wr)
    want, plain_ms = mean_ms(lambda: serial.serialize_poly(coeffs))
    enc, ms = mean_ms(lambda: lib.poly_encode(rows))
    same("poly_encode", enc, want, ms, plain_ms)
    want, plain_ms = mean_ms(lambda: serial.deserialize_poly(enc))
    dec, ms = mean_ms(lambda: lib.poly_decode(enc, wr))
    same("poly_decode", [int.from_bytes(r.tobytes(), "little") for r in dec],
         want, ms, plain_ms)
    check(np.array_equal(dec, rows), "native poly_decode != the rows")
    res["poly_encode"]["coefficients"] = len(coeffs)

    # hex of a proof
    proof = ts.create_proof(p, 0, 1).serialize()
    want, plain_ms = mean_ms(lambda: serial.to_hex(proof))
    h, ms = mean_ms(lambda: lib.hex_encode(proof))
    same("hex_encode", h, want, ms, plain_ms)
    want, plain_ms = mean_ms(lambda: serial.from_hex(h))
    got, ms = mean_ms(lambda: lib.hex_decode(h))
    same("hex_decode", got, want, ms, plain_ms)
    check(got == proof, "native hex_decode != the proof")

    # from_bytes -> from_blob through the limb matrix against the ints path
    cuda.reset_counts()

    def ys_lib():
        out = kzg.blob.from_bytes(data, 0, n * size, size)._ys(fr)
        sync()
        return out

    def ys_ints():
        out = fr.encode(serial.pack_chunks(data, n, size))
        sync()
        return out
    ys_ints()
    ys_lib()
    runs = {"ys_ints": ys_ints, "ys_lib": ys_lib,
            "from_blob_ints": lambda: kzg.poly.from_blob(kzg.blob(
                list(enumerate(serial.pack_chunks(data, n, size))))),
            "from_blob_lib": lambda: kzg.poly.from_blob(
                kzg.blob.from_bytes(data, 0, n * size, size))}
    outs = {}
    for name in ("ys_ints", "ys_lib", "ys_lib", "ys_ints", "from_blob_ints",
                 "from_blob_lib", "from_blob_lib", "from_blob_ints"):
        outs[name], cold, warm = host_ms(runs[name], WARM_RUNS)
        res.setdefault(name + "_ms", []).append(warm)
    launches = cuda.counts()
    check(torch.equal(fr.canon(outs["ys_lib"]), fr.canon(outs["ys_ints"])),
          "native: the uploaded limb matrix != fr.encode of the ints")
    a, b = outs["from_blob_lib"], outs["from_blob_ints"]
    check(a._n == b._n == n and torch.equal(pc.fr_raw(a._dev),
                                            pc.fr_raw(b._dev)),
          "native: from_bytes -> from_blob != the ints path on the card")
    check(launches["mont_mul"] > 0, "kernel mont_mul not launched on the "
          "native path")
    res["from_blob_chunks"] = n
    res["launches"] = {k: v for k, v in launches.items() if v}
    print(json.dumps({"native": res}), flush=True)
    line("native", t_all, f"card {card}: built with {res['compiler']} in "
         f"{build_s:.2f} s; every method == its plain version (pack "
         f"{res['pack_chunks_limbs']['ms']:.3f} vs "
         f"{res['pack_chunks_limbs']['plain_ms']:.3f} ms); short buffer "
         "raises; from_bytes -> from_blob == the ints path: ys "
         f"{min(res['ys_lib_ms']):.2f} vs {min(res['ys_ints_ms']):.2f} ms, "
         f"from_blob {min(res['from_blob_lib_ms']):.1f} vs "
         f"{min(res['from_blob_ints_ms']):.1f} ms")


def _parallel_rank(rank, ranks, rdv, inputs, out):
    """One of `ranks` ranks of the parallel phase (spawned; inputs["backend"]
    over a file:// rendezvous, every rank on the card unless
    inputs["device"] says otherwise): the sharded merge MSM (G1, G2), the sharded setup and the
    four-step NTT (forward, inverse, conv) on BLS12-381's and BN158's Fr, on
    the inputs saved at inputs["path"]. Rank 0 gathers every rank's results,
    times and launches into `out`."""
    import torch.distributed as dist

    import kzg_tpu_torch as kzg
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.ops.msm import MSMEngine
    from kzg_tpu_torch.ops.poly import PolyEngine
    from kzg_tpu_torch.parallel.distributed import init_distributed
    from kzg_tpu_torch.parallel.ntt import DistributedNTT
    from kzg_tpu_torch.parallel.sharded import (gather, make_mesh, shard,
                                                sharded_msm,
                                                sharded_setup_powers)
    from kzg_tpu_torch.protocol.api import power_digits
    dev_name = inputs["device"]
    init_distributed(inputs["backend"], f"file://{rdv}", ranks, rank)
    mesh = make_mesh(ranks, device=dev_name)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    data = torch.load(inputs["path"])
    res, ms, launches = {}, {}, {}

    def once(fn):
        if dev.type == "cuda":
            sync()
        dist.barrier()
        t0 = time.time()
        outv = fn()
        if dev.type == "cuda":
            sync()
        dist.barrier()
        return outv, (time.time() - t0) * 1e3

    def timed(name, fn, warm=True):
        """fn's cold run (its launches counted from 0) and, where `warm`,
        a second run: their wall ms between barriers."""
        cuda.reset_counts()
        outv, cold = once(fn)
        launches[name] = {k: v for k, v in cuda.counts().items() if v}
        ms[name] = {"cold": cold}
        if warm:
            outv, ms[name]["warm"] = once(fn)
        return outv

    pc = kzg.init("BN254", device=dev)
    ctx = pc.ctx
    sraw = data["scalars"].to(dev)
    for grp, G in (("g1", ctx.g1), ("g2", ctx.g2)):
        pts = {k: v.to(dev) for k, v in data[grp].items()}
        merge = MSMEngine(G, ctx.fr, ctx.cp.r, strategy="merge")
        run = sharded_msm(merge, mesh)
        tot = timed(f"msm_{grp}", lambda: run(shard(sraw, mesh),
                                              shard(pts, mesh)))
        res[f"msm_{grp}"] = G.affine_packed(
            {k: v[..., None] for k, v in tot.items()}).cpu()
    digits = power_digits(ctx.cp.r, MAIN_SECRET, data["setup_terms"], dev)
    wt1, wt2 = timed("setup_tables", pc.comb_tables, warm=False)
    for grp, G, wt in (("g1", ctx.g1, wt1), ("g2", ctx.g2, wt2)):
        run = sharded_setup_powers(G, mesh)
        block = timed(f"setup_{grp}", lambda: run(digits, wt))
        res[f"setup_{grp}_block"] = block["x"].shape[-1]
        res[f"setup_{grp}"] = G.affine_packed(gather(block, mesh)).cpu()
    for curve, xab in data["ntt"].items():
        c2 = get_context(curve, dev)
        F = c2.fr
        pe = PolyEngine(F, c2.cp)
        dntt = DistributedNTT(pe, mesh)
        x, a, b = (xab[k].to(dev) for k in ("x", "a", "b"))
        n = x.shape[-1]
        out_n = a.shape[-1] + b.shape[-1] - 1
        xs = shard(x, mesh)
        fwd = timed(f"ntt_{curve}", lambda: dntt(xs))
        back = timed(f"intt_{curve}", lambda: dntt(fwd, inverse=True))
        ca, cb = (shard(pe._pad_last(v, n), mesh) for v in (a, b))
        conv = timed(f"conv_{curve}", lambda: dntt.conv(ca, cb, out_n))
        canon = (lambda v: F.canon(F.from_mont(v)).cpu())
        res[f"ntt_{curve}"] = canon(gather(fwd, mesh))
        res[f"intt_{curve}"] = canon(gather(back, mesh))
        parts = [None] * ranks
        dist.all_gather_object(parts, canon(conv))
        res[f"conv_{curve}"] = torch.cat(parts, dim=-1)
    every = [None] * ranks
    dist.all_gather_object(every, {"ms": ms, "launches": launches})
    if rank == 0:
        torch.save({"res": res, "ranks_out": every}, out)
    dist.barrier()
    dist.destroy_process_group()


def phase_parallel(card, main_state, dev_name="cuda"):
    """The multi-device paths, once for each group of PAR_RUNS: PAR_RANKS
    ranks sharing the one card over gloo, then one rank over nccl (spawned
    with torch.multiprocessing, a file:// rendezvous; kernels built by
    phase_build, the ranks only load them): sharded_msm (merge) over the
    first PAR_MSM_POINTS setup points and coefficients == the single-process
    msm, G1 and G2; sharded_setup_powers for SETUP_TERMS terms from the main
    path's secret == from_secret's points, G1 and G2; DistributedNTT forward
    and inverse == PolyEngine.ntt and the input, its conv == PolyEngine.conv,
    at PAR_NTT's sizes. Each rank counts its own launches from 0 per
    subsystem; the K2/K4 adds, K6 and K1 must run on every rank."""
    import tempfile

    import torch.multiprocessing as mp

    from kzg_tpu_torch.ops.msm import MSMEngine
    from kzg_tpu_torch.ops.poly import PolyEngine
    from kzg_tpu_torch.context import get_context
    ts, p, _ = main_state
    pc = ts._pc
    ctx = pc.ctx
    t_all = time.time()
    n = PAR_MSM_POINTS
    sraw = pc.fr_raw(p.device_coeffs(pc))[..., :n]
    first = {grp: {k: v[..., :n] for k, v in pts.items()}
             for grp, pts in (("g1", ts._g1_points_dev()),
                              ("g2", ts._g2_points_dev()))}
    want = {}
    for grp, G in (("g1", ctx.g1), ("g2", ctx.g2)):
        eng = MSMEngine(G, ctx.fr, ctx.cp.r, strategy="merge")
        want[f"msm_{grp}"] = G.affine_packed(
            {k: v[..., None] for k, v in eng.msm(sraw, first[grp]).items()})
        want[f"setup_{grp}"] = G.affine_packed(
            ts._g1_points_dev() if grp == "g1" else ts._g2_points_dev())
    rng = random.Random(SEED + 11)
    inputs = {"scalars": sraw.cpu(), "setup_terms": ts._n, "ntt": {},
              **{grp: {k: v.cpu() for k, v in pts.items()}
                 for grp, pts in first.items()}}
    for curve, size in PAR_NTT.items():
        c2 = get_context(curve, ctx.device)
        F, r = c2.fr, c2.cp.r
        pe = PolyEngine(F, c2.cp)
        x = F.encode([rng.randrange(r) for _ in range(size)])
        a = F.encode([rng.randrange(r) for _ in range(size // 2)])
        b = F.encode([rng.randrange(r) for _ in range(size // 2)])
        inputs["ntt"][curve] = {"x": x.cpu(), "a": a.cpu(), "b": b.cpu()}
        fwd = pe.ntt(x)
        want[f"ntt_{curve}"] = F.canon(F.from_mont(fwd))
        want[f"intt_{curve}"] = F.canon(F.from_mont(x))
        want[f"conv_{curve}"] = F.canon(F.from_mont(pe.conv(a, b)))
    runs = {}
    with tempfile.TemporaryDirectory(prefix="kzg_par_") as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, path)
        for ranks, backend in PAR_RUNS:
            out = os.path.join(tmp, f"out_{backend}.pt")
            t0 = time.time()
            mp.spawn(_parallel_rank,
                     args=(ranks, os.path.join(tmp, f"rdv_{backend}"),
                           {"path": path, "device": dev_name,
                            "backend": backend}, out),
                     nprocs=ranks, join=True)
            runs[backend] = {"ranks": ranks,
                             "spawn_to_join_ms": (time.time() - t0) * 1e3,
                             **torch.load(out)}
    need = {"msm_g1": ("g1_add", "merge_combine_g1"),
            "msm_g2": ("g2_add", "merge_combine_g2"),
            "setup_g1": ("g1_add",), "setup_g2": ("g2_add",),
            **{f"{op}_{curve}": ("mont_mul" if curve == BLS else
                                 "mont_mul@11",)
               for curve in PAR_NTT for op in ("ntt", "intt", "conv")}}
    for backend, run in runs.items():
        res, ranks = run["res"], run["ranks"]
        what = f"parallel ({backend}, {ranks} ranks)"
        for key, w in want.items():
            check(torch.equal(res[key], w.cpu()), f"{what} {key} != the "
                  "single-process result")
        check(res["setup_g1_block"] == res["setup_g2_block"] ==
              ts._n // ranks, f"{what} setup: a rank's block")
        for i, rk in enumerate(run["ranks_out"]):
            for sub, names in need.items():
                for name in names:
                    check(rk["launches"][sub].get(name, 0) > 0,
                          f"{what} rank {i} {sub}: kernel {name} not "
                          "launched")
    print(json.dumps({"parallel": {
        "card": card, "msm_points": n, "setup_terms": ts._n, "ntt": PAR_NTT,
        **{backend: {"ranks": run["ranks"],
                     "spawn_to_join_ms": run["spawn_to_join_ms"],
                     "wall_ms_by_rank": [rk["ms"] for rk in run["ranks_out"]],
                     "launches_by_rank": [rk["launches"]
                                          for rk in run["ranks_out"]]}
           for backend, run in runs.items()}}}), flush=True)

    def warm(backend, key):
        v = runs[backend]["ranks_out"][0]["ms"][key]
        return v.get("warm", v["cold"])
    line("parallel", t_all, "sharded msm over "
         f"{n} points == msm, sharded setup of {ts._n} == from_secret, "
         "DistributedNTT forward / inverse / conv == PolyEngine at "
         + ", ".join(f"{c} n={v}" for c, v in PAR_NTT.items()) + "; "
         + "; ".join(
             f"{run['ranks']} rank(s) over {backend}: warm rank 0 msm G1 "
             f"{warm(backend, 'msm_g1'):.0f} ms, G2 "
             f"{warm(backend, 'msm_g2'):.0f} ms, setup G1 "
             f"{warm(backend, 'setup_g1'):.0f} ms, G2 "
             f"{warm(backend, 'setup_g2'):.0f} ms, spawn to join "
             f"{run['spawn_to_join_ms']:.0f} ms"
             for backend, run in runs.items()))


def profile_ops(ops, top=6):
    """One warm run of each op under torch.profiler (device activity only):
    its wall time (under the profiler), the device time summed over its
    kernels and copies, their ratio (the device's busy share), its device
    launches and the kernels that took the most device time. A run in
    which the profiler reported no device activity is recorded as not
    measured (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in ops.items():
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            sync()
            wall = (time.time() - t0) * 1e3
        dev = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
        dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
        out[name] = {
            "wall_ms": wall, "device_ms": dev_ms if dev_ms else None,
            "busy_share": dev_ms / wall if dev_ms else None,
            "launches": sum(e.count for e in dev),
            "top": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                    for e in dev[:top]]}
    return out


def heaviest(shapes):
    """The shape that carries the most lanes for a kernel over its paths'
    runs."""
    def work(item):
        key, n = item
        lanes = key[0] * key[1] if isinstance(key, tuple) else key
        return lanes * n
    return max(shapes.items(), key=work)[0]


def tiled(batch, lanes):
    """A point batch (last axis B lanes) repeated along its lanes up to
    `lanes` lanes (the inputs of a wide timing, made from a narrow batch)."""
    reps = -(-lanes // batch["x"].shape[-1])
    return {k: v.repeat((1,) * (v.ndim - 1) + (reps,))[..., :lanes]
            .contiguous() for k, v in batch.items()}


def point_work(L, comps, coords, muls, lanes):
    """(bytes, operations) of a point kernel over `lanes` lanes: `coords`
    coordinates of `comps` base elements of L int64 limbs moved and `muls`
    base Montgomery products done per lane."""
    return (coords * comps * L * 8 * lanes,
            muls * 2 * macs_per_mul(L) * lanes)


def point_muls(G):
    """(base elements of a coordinate, base Montgomery products of the
    plain add, of the plain doubling) of group G (Curve._add_plain,
    _dbl_plain; a scale by a small constant is not a product). G1: an add
    does 12 products and a doubling 9, and 14 and 10 where 3b > 14 is a
    product (BN158). G2: an add does 14 Fp2 products of 3 base products, a
    doubling 9 Fp2 products."""
    if G.is_fp2:
        return 2, 42, 27
    b3_mul = G._b3_int > 14
    return 1, 12 + 2 * b3_mul, 9 + b3_mul


def point_variants(kname, L):
    """The variants that point kernel `kname` (K2 "g1_add", K3 "g1_dbl", K4
    "g2_add", K5 "g2_dbl") at L limbs is held and timed on: (True, False),
    the split and the lane executor, where its width rule has an entry at
    L (K2-K5 at 25 and at 11 limbs, K2 and K4 at 17), else (None,), the
    one executor."""
    from kzg_tpu_torch.ops import cuda
    return (True, False) if L in cuda.SPLIT_BELOW[kname] else (None,)


def both_executors(variants):
    """The checks' wording for a kernel held on `variants`."""
    return " on both executors (split and lane)" if len(variants) == 2 else ""


def team_kw(team):
    """The wrapper's keyword that forces a K2-K5 variant (none: the width
    rule)."""
    return {} if team is None else {"team": team}


def merge_inputs(base_p, base_q, lanes, gen):
    """K6's operands over `lanes` lanes: aR, bL the two batches tiled, aL,
    bR the same tiled and rolled, and random masks fuse, asing, bsing."""
    aR, bL = tiled(base_p, lanes), tiled(base_q, lanes)
    aL = {k: v.roll(3, dims=-1).contiguous()
          for k, v in tiled(base_q, lanes).items()}
    bR = {k: v.roll(5, dims=-1).contiguous()
          for k, v in tiled(base_p, lanes).items()}
    masks = [torch.rand(lanes, generator=gen, device=aR["x"].device) < 0.5
             for _ in range(3)]
    return aL, aR, bL, bR, masks


def merge_work(L, comps, add_muls, lanes):
    """(bytes, operations) of K6 over `lanes` lanes: 7 points of 3
    coordinates and 3 mask bytes moved, one add done per lane."""
    nbytes, ops = point_work(L, comps, 7 * 3, add_muls, lanes)
    return nbytes + 3 * lanes, ops


def merge_sweep(paths, ctx, G, base_p, base_q, bound, errs, gen):
    """K6 of G's group at every width the paths launched: held exactly
    against MSMEngine._combine_plain (canonical affine points of mid, newL,
    newR) with random masks, then timed from contiguous inputs (ms, the
    kernel alone) and from the stride-2 halves of interleaved sums, as a
    merge level gives them (halves_ms: the wrapper's call, with whatever
    copies it makes). At a limb count of team.MERGE_DIGITS, where K6's
    products run on 32-bit digits, its raw output is also held limb for
    limb against team.plain_merge's, the digit product's CPU model."""
    from kzg_tpu_torch.ops import cuda, team
    from kzg_tpu_torch.ops.msm import MSMEngine
    grp = "g2" if G.is_fp2 else "g1"
    comps, add_muls, _ = point_muls(G)
    L = G.F.base.L if G.is_fp2 else G.F.L
    name = cuda.kernel_key(f"merge_combine_{grp}", L)
    eng = MSMEngine(G, ctx.fr, ctx.cp.r, strategy="merge")
    keys = sorted({key for _, shp in paths.values()
                   for key in shp.get(name, {})})
    rows = []
    path_ms = dict.fromkeys(paths, 0.0)
    halves_path_ms = dict.fromkeys(paths, 0.0)
    for lanes in keys:
        aL, aR, bL, bR, masks = merge_inputs(base_p, base_q, lanes, gen)
        got = cuda.merge_combine(G, aL, aR, bL, bR, *masks)
        want = eng._combine_plain(aL, aR, bL, bR, *masks)
        a = torch.cat([G.affine_packed(P) for P in got], dim=-1)
        b = torch.cat([G.affine_packed(P) for P in want], dim=-1)
        err = (a - b).abs().max().item()
        if L in team.MERGE_DIGITS:
            raw = team.plain_merge(G, aL, aR, bL, bR, *masks)
            err = max([err] + [(x[c] - y[c]).abs().max().item()
                               for x, y in zip(got, raw)
                               for c in ("x", "y", "z")])
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} at {lanes}: kernel != plain (max {err})")
        ms = kernel_ms(lambda: cuda.merge_combine(G, aL, aR, bL, bR, *masks))
        hv, single = halves(aL, aR, bL, bR, masks[1:], (lanes,))
        hs = (masks[0], single[..., 0::2], single[..., 1::2])
        hms = kernel_ms(lambda: cuda.merge_combine(G, *hv, *hs))
        by_path = {path: shp.get(name, {}).get(lanes, 0)
                   for path, (_, shp) in paths.items()}
        for path, n in by_path.items():
            path_ms[path] += n * ms
            halves_path_ms[path] += n * hms
        bms, by = bound(*merge_work(L, comps, add_muls, lanes))
        rows.append({"lanes": lanes, "launches_by_path": by_path, "ms": ms,
                     "halves_ms": hms, "bound_ms": bms, "bound_by": by,
                     "max_abs_err": err})
    return {"shapes": rows, "path_ms": path_ms,
            "halves_path_ms": halves_path_ms, "gap_ms": gaps(rows, paths)}


def gaps(rows, paths):
    """Per path, the sum over a kernel's swept shapes of launches x (ms -
    bound_ms): the device time it spends above its bound."""
    return {path: sum(r["launches_by_path"][path] * (r["ms"] - r["bound_ms"])
                      for r in rows) for path in paths}


def sweep(paths, ctx, bases, bound, errs, gen):
    """K2-K6 at the limb count of the context ctx's Fp, at every distinct
    shape of the paths: each held against its plain version (exact
    canonical affine points), then its device time per launch (kernel_ms)
    and bound; per path, path_ms = sum over shapes of the path's launches x
    ms, and gap_ms the same of ms - bound_ms. bases: {group: (curve, P,
    Q)}. An add moves 9 coordinates, a chain 6 (K6: merge_sweep). A point
    kernel with a width rule at L in both variants (point_variants):
    split_ms and lane_ms, each the median of three kernel_ms taken in
    turns, ms and `ships` the one the width rule picks, floor_ms an empty
    kernel on its grid; per path also lane_path_ms (every launch on the
    lane executor), floor_ms and the launches of each variant."""
    from kzg_tpu_torch.ops import cuda
    res = {}
    L = ctx.fp.L
    for kname in ("g1_add", "g1_dbl", "g2_add", "g2_dbl"):
        grp = kname[:2]
        name = cuda.kernel_key(kname, L)
        G, base_p, base_q = bases[grp]
        comps, add_muls, dbl_muls = point_muls(G)
        kadd, kdbl = getattr(cuda, f"{grp}_add"), getattr(cuda, f"{grp}_dbl")
        variants = point_variants(kname, L)
        keys = sorted({key for _, shp in paths.values()
                       for key in shp.get(name, {})},
                      key=lambda k: k if isinstance(k, tuple) else (k,))
        rows, path_ms = [], dict.fromkeys(paths, 0.0)
        sums = {k: dict.fromkeys(paths, 0.0)
                for k in ("lane_path_ms", "floor_ms")}
        by_variant = {v: dict.fromkeys(paths, 0) for v in ("split", "lane")}
        for key in keys:
            lanes, times = key if isinstance(key, tuple) else (key, None)
            P, Q = tiled(base_p, lanes), tiled(base_q, lanes)
            if times is None:
                def kern(team=None):
                    return kadd(G, P, Q, **team_kw(team))

                def plain():
                    return G._add_plain(P, Q)
            else:
                def kern(team=None):
                    return kdbl(G, P, times, **team_kw(team))

                def plain():
                    R = P
                    for _ in range(times):
                        R = G._dbl_plain(R)
                    return R
            want = G.affine_packed(plain())
            err = 0
            for team in variants:
                e = (G.affine_packed(kern(team)) - want).abs().max().item()
                err = max(err, e)
                errs[name] = max(errs[name], e)
                check(e == 0, f"{name} team={team} at {key}: kernel != plain "
                      f"(max {e})")
            by_path = {path: shp.get(name, {}).get(key, 0)
                       for path, (_, shp) in paths.items()}
            b, by = bound(*point_work(L, comps, 9 if times is None else 6,
                                      add_muls if times is None
                                      else dbl_muls * times,
                                      lanes))
            row = {"lanes": lanes, "times": times,
                   "launches_by_path": by_path}
            if len(variants) == 1:
                row["ms"] = kernel_ms(kern)
            else:
                runs = {True: [], False: []}
                for _ in range(3):
                    for team in variants:
                        runs[team].append(kernel_ms(lambda: kern(team)))
                ms = {team: statistics.median(v) for team, v in runs.items()}
                ships = cuda.uses_split(kname, L, lanes)
                grid = cuda.point_grid(kname, L, lanes)
                floor = kernel_ms(lambda: cuda.empty_launch(*grid))
                row.update(ships="split" if ships else "lane", ms=ms[ships],
                           split_ms=ms[True], lane_ms=ms[False],
                           floor_ms=floor)
                for path, n in by_path.items():
                    sums["lane_path_ms"][path] += n * ms[False]
                    sums["floor_ms"][path] += n * floor
                    by_variant[row["ships"]][path] += n
            for path, n in by_path.items():
                path_ms[path] += n * row["ms"]
            row.update(bound_ms=b, bound_by=by, max_abs_err=err)
            rows.append(row)
        res[name] = {"shapes": rows, "path_ms": path_ms,
                     "gap_ms": gaps(rows, paths)}
        if len(variants) == 2:
            res[name].update(team_below=cuda.SPLIT_BELOW[kname][L], **sums,
                             launches_by_variant=by_variant)
    for grp in ("g1", "g2"):
        res[cuda.kernel_key(f"merge_combine_{grp}", L)] = merge_sweep(
            paths, ctx, *bases[grp], bound, errs, gen)
    return res


def k1_sweep(paths, F, bound, errs, name, gen):
    """K1 on field F (entry `name`) at every width the paths launched it:
    both variants held exactly against Field._mul_plain on lazy inputs and
    timed (team_ms, lane_ms, each the median of three kernel_ms taken in
    turns; ms and `ships` are the variant the width rule picks), floor_ms (an empty kernel on the shipped variant's grid, timed
    the same way) and the bound (3 L int64 limbs moved, 2 L^2 + L
    multiply-accumulates, per lane); per path path_ms, gap_ms, floor_ms
    (launches x floor_ms), lane_path_ms (every launch on the thread-per-lane
    variant) and each variant's launches."""
    from kzg_tpu_torch.ops import cuda
    L = F.L
    key = cuda.kernel_key("mont_mul", L)
    widths = sorted({w for _, shp in paths.values() for w in shp.get(key, {})})
    n = max(widths)
    a0, b0 = lazy_limbs(F, n, gen), lazy_limbs(F, n, gen)
    rows = []
    sums = {k: dict.fromkeys(paths, 0.0)
            for k in ("path_ms", "floor_ms", "lane_path_ms")}
    by_variant = {v: dict.fromkeys(paths, 0) for v in ("team", "lane")}
    for w in widths:
        a, b = a0[:, :w].contiguous(), b0[:, :w].contiguous()
        want = F._mul_plain(a, b)
        err = 0
        for team in (True, False):
            err = max(err, (cuda.mont_mul(F, a, b, team=team)
                            - want).abs().max().item())
            errs[name] = max(errs[name], err)
            check(err == 0, f"{name} team={team} at {w}: kernel != plain "
                  f"(max {err})")
        # the two variants differ by a few percent at 11 limbs: the median
        # of three timings each, taken in turns
        runs = {True: [], False: []}
        for _ in range(3):
            for team in (True, False):
                runs[team].append(kernel_ms(
                    lambda: cuda.mont_mul(F, a, b, team=team)))
        ms = {team: statistics.median(v) for team, v in runs.items()}
        ships = cuda.k1_uses_team(L, w)
        grid = cuda.k1_grid(L, w)
        floor = kernel_ms(lambda: cuda.empty_launch(*grid))
        by_path = {path: shp.get(key, {}).get(w, 0)
                   for path, (_, shp) in paths.items()}
        for path, k in by_path.items():
            sums["path_ms"][path] += k * ms[ships]
            sums["floor_ms"][path] += k * floor
            sums["lane_path_ms"][path] += k * ms[False]
            by_variant["team" if ships else "lane"][path] += k
        bms, by = bound(3 * L * 8 * w, 2 * macs_per_mul(L) * w)
        rows.append({"lanes": w, "launches_by_path": by_path,
                     "ships": "team" if ships else "lane", "ms": ms[ships],
                     "team_ms": ms[True], "lane_ms": ms[False],
                     "floor_ms": floor, "bound_ms": bms, "bound_by": by,
                     "max_abs_err": err})
    return {"team_below": cuda.K1_TEAM_BELOW[L], "shapes": rows, **sums,
            "gap_ms": gaps(rows, paths), "launches_by_variant": by_variant}


def bound(nbytes, ops):
    """(bound_ms, what bounds it) of work moving `nbytes` and doing `ops`
    operations at the card's published peaks."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def phase_kernel_line(dev, curve_paths, errs):
    """curve_paths: {curve: {path: (launches, shapes)}} of each curve's main
    and msm runs, which its kernels are counted and swept on (BLS12-381's
    25-limb kernels and K1 on its Fr on main_bls and msm_bls, BN158's
    11-limb kernels on main_bn158 and msm_bn158)."""
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.ops.msm import MSMEngine
    t0 = time.time()
    out = []

    def entry(name, key, on, kernel_fn, plain_fn, canon, nbytes, ops,
              shape, by_path=None, **extra):
        """Hold the kernel (launch counter `key`, counted on the paths
        `on`; `by_path`: a variant's launches instead) against its plain
        version at this shape (exact canonical equality), then time
        both."""
        k = cuda.KERNELS[key]
        a, b = canon(kernel_fn()), canon(plain_fn())
        err = (a - b).abs().max().item()
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} at {shape}: kernel != plain (max {err})")
        ms = kernel_ms(kernel_fn)
        plain = event_ms(plain_fn, iters=3)
        b, by = bound(nbytes, ops)
        if by_path is None:
            by_path = {path: lc[key] for path, (lc, _) in on.items()}
        out.append({"name": name, "route": "cuda", "source": k.source,
                    "replaces": k.replaces, "limbs": k.limbs,
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                    "bound_ms": b, "bound_by": by, "library_ms": None,
                    "shape": shape, "event_ms": event_ms(kernel_fn),
                    **extra})

    def variant_entries(Gc, key, lanes_of, kernel_fn, plain_fn, work,
                        shape_of, shapes):
        """A point kernel with a width rule at its limb count (launch
        counter `key`) in each variant: an entry named key (the lane
        executor) and key + " split", each at the heaviest shape the width
        rule gave that variant (the heaviest of all where it got none),
        with that variant's launches per path; the split executor must
        have run on the paths."""
        kname = key.split("@")[0]
        L = Gc.F.base.L if Gc.is_fp2 else Gc.F.L
        for team in (True, False):
            mine = {k: n for k, n in shapes[key].items()
                    if cuda.uses_split(kname, L, lanes_of(k)) == team}
            by_path = {path: sum(n for k, n in shp.get(key, {}).items()
                                 if cuda.uses_split(kname, L, lanes_of(k))
                                 == team)
                       for path, (_, shp) in on.items()}
            shp = heaviest(mine or shapes[key])
            variant = "split" if team else "lane"
            if team:
                check(sum(by_path.values()) > 0, f"{key}: the split "
                      "executor not launched on the paths")
            entry(key + (" split" if team else ""), key, on,
                  kernel_fn(shp, team), plain_fn(shp), Gc.affine_packed,
                  *work(shp), shape_of(shp), by_path=by_path,
                  variant=variant,
                  team_below=cuda.SPLIT_BELOW[kname][L])

    def packed_all(G):
        def canon(pts):
            return torch.cat([G.affine_packed(P) for P in pts], dim=-1)
        return canon

    def curve_entries(curve, on, seed):
        """The entries of `curve`'s kernels at the heaviest shapes of the
        paths `on`; returns its sweep."""
        ctx = get_context(curve, dev)
        G, G2 = ctx.g1, ctx.g2
        L = ctx.fp.L
        gen = torch.Generator(device=dev).manual_seed(seed)
        rng = random.Random(seed)
        shapes = {}
        for _, shp in on.values():
            for name, d in shp.items():
                for key, n in d.items():
                    shapes.setdefault(name, {})
                    shapes[name][key] = shapes[name].get(key, 0) + n

        k1 = {cuda.kernel_key("mont_mul", F.L): F for F in (ctx.fr, ctx.fp)}
        k1_swept = {}
        for key, F in k1.items():       # one entry per instance of K1
            lanes = heaviest(shapes[key])
            a, b = lazy_limbs(F, lanes, gen), lazy_limbs(F, lanes, gen)
            entry(k1_entry(curve, F), key, on,
                  lambda F=F, a=a, b=b: cuda.mont_mul(F, a, b),
                  lambda F=F, a=a, b=b: F._mul_plain(a, b), F.canon,
                  3 * F.L * 8 * lanes, 2 * macs_per_mul(F.L) * lanes,
                  {"lanes": lanes})
            k1_swept[k1_entry(curve, F)] = k1_sweep(
                on, F, bound, errs, k1_entry(curve, F), gen)
            for path in on:
                if path.startswith("main"):
                    check(k1_swept[k1_entry(curve, F)]["launches_by_variant"]
                          ["team"][path] > 0, f"K1 {key}: the lane-team "
                          f"variant not launched on the {path} path")

        bases = {}
        for grp, Gc, inputs in (("g1", G, g1_inputs), ("g2", G2, g2_inputs)):
            comps, add_muls, dbl_muls = point_muls(Gc)
            add = cuda.kernel_key(f"{grp}_add", L)
            dbl = cuda.kernel_key(f"{grp}_dbl", L)
            kadd = getattr(cuda, f"{grp}_add")
            kdbl = getattr(cuda, f"{grp}_dbl")
            base_p, base_q, _, _, _ = inputs(ctx, K23_LANES, rng)
            bases[grp] = (Gc, base_p, base_q)

            def add_fn(lanes, team=None):
                P, Q = tiled(base_p, lanes), tiled(base_q, lanes)
                return lambda: kadd(Gc, P, Q, **team_kw(team))

            def add_plain(lanes):
                P, Q = tiled(base_p, lanes), tiled(base_q, lanes)
                return lambda: Gc._add_plain(P, Q)

            def dbl_fn(shape, team=None):
                P = tiled(base_p, shape[0])
                return lambda: kdbl(Gc, P, shape[1], **team_kw(team))

            def chain(shape):
                P = tiled(base_p, shape[0])

                def run():
                    R = P
                    for _ in range(shape[1]):
                        R = Gc._dbl_plain(R)
                    return R
                return run

            def add_work(lanes):
                return point_work(L, comps, 9, add_muls, lanes)

            def dbl_work(shape):
                return point_work(L, comps, 6, dbl_muls * shape[1], shape[0])

            for key, lanes_of, fn, plain, work, shape_of in (
                    (add, lambda k: k, add_fn, add_plain, add_work,
                     lambda k: {"lanes": k}),
                    (dbl, lambda k: k[0], dbl_fn, chain, dbl_work,
                     lambda k: {"lanes": k[0], "times": k[1]})):
                if len(point_variants(key.split("@")[0], L)) == 2:
                    variant_entries(Gc, key, lanes_of, fn, plain, work,
                                    shape_of, shapes)
                else:
                    shp = heaviest(shapes[key])
                    entry(key, key, on, fn(shp), plain(shp),
                          Gc.affine_packed, *work(shp), shape_of(shp))

            name = cuda.kernel_key(f"merge_combine_{grp}", L)
            lanes = heaviest(shapes[name])
            aL, aR, bL, bR, masks = merge_inputs(base_p, base_q, lanes, gen)
            eng = MSMEngine(Gc, ctx.fr, ctx.cp.r, strategy="merge")
            entry(name, name, on,
                  lambda: cuda.merge_combine(Gc, aL, aR, bL, bR, *masks),
                  lambda: eng._combine_plain(aL, aR, bL, bR, *masks),
                  packed_all(Gc), *merge_work(L, comps, add_muls, lanes),
                  {"lanes": lanes})
        return {**k1_swept, **sweep(on, ctx, bases, bound, errs, gen)}

    swept = {}
    for curve, on in curve_paths.items():
        swept.update(curve_entries(curve, on, SEED + {"BN254": 1, BLS: 8,
                                                      BN158: 10}[curve]))
    print(json.dumps({"sweep": swept}), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    line("kernels", t0, "each kernel == its plain version at the heaviest "
         "shape its path gave it; ms = device time per launch (CUDA events, "
         "launches queued behind a spin kernel), event_ms and plain_ms = "
         "CUDA events around back-to-back calls (host gaps included; plain "
         "= the PyTorch version on the same tensors); launches = its "
         "curve's main and msm paths' runs (BN254's with multiproof)")


def main_only(dev):
    """`--main-only`: the BN254 main phase alone (its main_path and profile
    lines), after building the 17-limb kernels. It uses only the package's
    init, protocol and launch counters, so this script also runs it beside
    a tree of the package that predates BLS12-381, to compare the two."""
    from kzg_tpu_torch.ops import cuda
    t0 = time.time()
    cuda.build()
    card = smi()
    line("build", t0, f"card: {card}")
    phase_main(dev, card)
    print(card, flush=True)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import kzg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: kzg_tpu_torch not importable ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if sys.argv[1:] == ["--main-only"]:
        return main_only(dev)
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    t_start = time.time()
    card = phase_build()
    errs = collections.defaultdict(int)        # kernel entry -> max error
    for curve in ("BN254", BLS, BN158):
        phase_kernels(dev, errs, curve)
    phase_split_fit(dev, card, errs)
    phase_golden(dev)
    phase_golden(dev, BLS)
    phase_oracle(dev, BN158)
    curve_paths, states = {}, {}
    for curve in ("BN254", BLS, BN158):
        launches, shapes, states[curve] = phase_main(dev, card, curve)
        label, sfx = LABEL[curve]
        curve_paths[curve] = {label: (launches, shapes),
                              "msm" + sfx: phase_msm(card, states[curve])}
    curve_paths["BN254"]["multiproof"] = phase_multiproof(
        card, states["BN254"], main_message())
    phase_native(dev, card, states["BN254"])
    phase_cli(dev, card, states["BN254"])
    phase_demo(dev, card)
    phase_parallel(card, states["BN254"])
    phase_kernel_line(dev, curve_paths, errs)
    check("jax" not in sys.modules and not any(
        m == "kzg_tpu" or m.startswith("kzg_tpu.") for m in sys.modules),
        "no JAX and nothing of the JAX package imported")
    print(f"total {time.time() - t_start:.1f}s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
