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
               K2/K4 (G1/G2 complete add, with and without reset mask)
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
               ~2964 p, checked on the plain schedule's statistics); and on
               BN158: K1 at 11 limbs on Fp and Fr, with lanes at the G1
               add's widest operands (~186 p times ~186 p) and at the G2
               Karatsuba's (8 (c0 + c1) of qnr = 5 products, limbs up to
               56 x 65535), and K2-K6 at 11 limbs (G1 with 3b = 39 a
               product, G2 with qnr = 5);
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
  8. kernels line — each kernel held against its plain version once more at
               the heaviest shape its path gave it, then one JSON object:
               each kernel's launches on its curve's main and msm paths,
               its largest error against the plain version, its device time
               per launch, the plain version's time per call, and the bound
               at that shape; before it the "sweep" line: K1-K6 of each
               limb count held against their plain versions and timed at
               every distinct shape their curve's paths launched, with each
               path's device time in the kernel (path_ms = sum of launches x
               ms) and above its bound (gap_ms = sum of launches x (ms -
               bound)); K1 in both variants (team_ms, lane_ms, `ships`: the
               one the width rule picks, which ms is) beside floor_ms, an
               empty kernel's launch on the shipped variant's grid, and the
               lane-team variant must have run on each main path; K6 also
               timed from a merge level's stride-2 halves, the wrapper's
               copies included (halves_ms, halves_path_ms).
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

def phase_build():
    from kzg_tpu_torch.ops import cuda
    t0 = time.time()
    secs = cuda.build(limbs=cuda.LIMBS)
    card = smi()
    for L in cuda.LIMBS:
        for name in cuda.SOURCES:
            for ln in cuda.build_log(name, L).splitlines():
                if "registers" in ln or "spill" in ln or "stack" in ln:
                    print(f"[build] {cuda.kernel_key(name, L)}: "
                          f"{ln.strip()}")
    line("build", t0, "nvcc sm_90a built in parallel, seconds to each "
         f"finish: { {k: round(v, 1) for k, v in secs.items()} }; card: "
         f"{card}")
    return card


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
        k = add(G, P, Q)
        fresh_points(G, k, kadd)
        got = G.unpack_affine(same_points(G, k, G._add_plain(P, Q),
                                          f"{kadd}", kadd, errs))
        for i in sample:
            check(got[i] == og.add(pts_p[i], pts_q[i]),
                  f"{kadd} lane {i} vs oracle")
        mask = torch.rand(lanes, generator=gen, device=dev) < 0.3
        k = add(G, P, Q, mask)
        fresh_points(G, k, f"{kadd} reset")
        same_points(G, k, G.select(mask, Q, G._add_plain(P, Q)),
                    f"{kadd} reset mask", kadd, errs)
        for times in (1, 8):
            k = dbl(G, P, times)
            fresh_points(G, k, kdbl)
            ref = P
            for _ in range(times):
                ref = G._dbl_plain(ref)
            got = G.unpack_affine(same_points(G, k, ref,
                                              f"{kdbl} times={times}", kdbl,
                                              errs))
            for i in sample:
                check(got[i] == og.mul(1 << times, pts_p[i]),
                      f"{kdbl} times={times} lane {i} vs oracle")
        # the largest product inputs of the add's schedule on these lanes
        stats = {}
        team.plain_add(G, {c: v[..., :64] for c, v in P.items()},
                       {c: v[..., :64] for c, v in Q.items()}, stats=stats)
        p = p_of(G)
        check(stats["value"] > WIDEST[curve, grp] * p,
              f"{kadd}: the checked adds miss the widest operands")
        widest = (f"; the add's product inputs reach "
                  f"{stats['value'] / p:.1f} p, limbs {stats['limb']}, a b "
                  f"= {stats['ab'] / (p << (16 * L)):.4f} R p")
        line("kernels", t0, f"{kadd} (with/without reset mask) and {kdbl} "
             f"(times 1, 8) == plain as canonical affine points over {lanes} "
             "lanes incl. infinity/doubling/negation; outputs exact 16-bit, "
             f"< 1.1p; 24 lanes vs oracle{widest}")
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
    for n in EDGE_LANES:
        Pn = {k: v[..., :n].contiguous() for k, v in P.items()}
        Qn = {k: v[..., :n].contiguous() for k, v in Q.items()}
        what = f"{kadd} lanes={n}"
        k = add(G, Pn, Qn)
        fresh_points(G, k, what)
        got = G.unpack_affine(same_points(G, k, G._add_plain(Pn, Qn), what,
                                          kadd, errs))
        for i in range(min(n, 8)):
            check(got[i] == og.add(pts_p[i], pts_q[i]), f"{what} lane {i} "
                  "vs oracle")
        mask = torch.rand(n, generator=gen, device=P["x"].device) < 0.5
        k = add(G, Pn, Qn, mask)
        fresh_points(G, k, f"{what} reset")
        same_points(G, k, G.select(mask, Qn, G._add_plain(Pn, Qn)),
                    f"{what} reset mask", kadd, errs)
        for times in (1, 8):
            what = f"{kdbl} lanes={n} times={times}"
            k = dbl(G, Pn, times)
            fresh_points(G, k, what)
            ref = Pn
            for _ in range(times):
                ref = G._dbl_plain(ref)
            got = G.unpack_affine(same_points(G, k, ref, what, kdbl, errs))
            for i in range(min(n, 8)):
                check(got[i] == og.mul(1 << times, pts_p[i]),
                      f"{what} lane {i} vs oracle")
    line("kernels", t0, f"{kadd} (with/without reset mask) and {kdbl} (times "
         f"1, 8) == plain at edge widths {EDGE_LANES} lanes; outputs exact "
         "16-bit, < 1.1p; first 8 lanes vs oracle")


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


def phase_main(dev, card, curve="BN254"):
    """bench.py's path on `curve`; its JSON lines are main_path and profile
    on BN254, main_path_bls and profile_bls on BLS12-381, main_path_bn158
    and profile_bn158 on BN158."""
    import kzg_tpu_torch as kzg
    from kzg_tpu_torch.ops import cuda
    label, sfx = LABEL[curve]
    required = PATH_KERNELS[curve]
    pc = kzg.init(curve, device=dev)
    random.seed(1)                       # bench.py's message
    data = "".join(chr(random.randrange(32, 127)) for _ in range(DEGREE + 1))
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
    copies it makes)."""
    from kzg_tpu_torch.ops import cuda
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
    Q)}. An add moves 9 coordinates, a chain 6 (K6: merge_sweep)."""
    from kzg_tpu_torch.ops import cuda
    res = {}
    L = ctx.fp.L
    for kname in ("g1_add", "g1_dbl", "g2_add", "g2_dbl"):
        grp = kname[:2]
        name = cuda.kernel_key(kname, L)
        G, base_p, base_q = bases[grp]
        comps, add_muls, dbl_muls = point_muls(G)
        kadd, kdbl = getattr(cuda, f"{grp}_add"), getattr(cuda, f"{grp}_dbl")
        keys = sorted({key for _, shp in paths.values()
                       for key in shp.get(name, {})},
                      key=lambda k: k if isinstance(k, tuple) else (k,))
        rows, path_ms = [], dict.fromkeys(paths, 0.0)
        for key in keys:
            lanes, times = key if isinstance(key, tuple) else (key, None)
            P, Q = tiled(base_p, lanes), tiled(base_q, lanes)
            if times is None:
                def kern():
                    return kadd(G, P, Q)

                def plain():
                    return G._add_plain(P, Q)
            else:
                def kern():
                    return kdbl(G, P, times)

                def plain():
                    R = P
                    for _ in range(times):
                        R = G._dbl_plain(R)
                    return R
            a, b = G.affine_packed(kern()), G.affine_packed(plain())
            err = (a - b).abs().max().item()
            errs[name] = max(errs[name], err)
            check(err == 0, f"{name} at {key}: kernel != plain (max {err})")
            ms = kernel_ms(kern)
            by_path = {path: shp.get(name, {}).get(key, 0)
                       for path, (_, shp) in paths.items()}
            for path, n in by_path.items():
                path_ms[path] += n * ms
            b, by = bound(*point_work(L, comps, 9 if times is None else 6,
                                      add_muls if times is None
                                      else dbl_muls * times,
                                      lanes))
            rows.append({"lanes": lanes, "times": times,
                         "launches_by_path": by_path, "ms": ms,
                         "bound_ms": b, "bound_by": by, "max_abs_err": err})
        res[name] = {"shapes": rows, "path_ms": path_ms,
                     "gap_ms": gaps(rows, paths)}
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
              shape):
        """Hold the kernel (launch counter `key`, counted on the paths
        `on`) against its plain version at this shape (exact canonical
        equality), then time both."""
        k = cuda.KERNELS[key]
        a, b = canon(kernel_fn()), canon(plain_fn())
        err = (a - b).abs().max().item()
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} at {shape}: kernel != plain (max {err})")
        ms = kernel_ms(kernel_fn)
        plain = event_ms(plain_fn, iters=3)
        b, by = bound(nbytes, ops)
        by_path = {path: lc[key] for path, (lc, _) in on.items()}
        out.append({"name": name, "route": "cuda", "source": k.source,
                    "replaces": k.replaces, "limbs": k.limbs,
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                    "bound_ms": b, "bound_by": by, "library_ms": None,
                    "shape": shape, "event_ms": event_ms(kernel_fn)})

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
            lanes = heaviest(shapes[add])
            P, Q = tiled(base_p, lanes), tiled(base_q, lanes)
            entry(add, add, on, lambda: kadd(Gc, P, Q),
                  lambda: Gc._add_plain(P, Q), Gc.affine_packed,
                  *point_work(L, comps, 9, add_muls, lanes),
                  {"lanes": lanes})

            lanes, times = heaviest(shapes[dbl])
            P = tiled(base_p, lanes)

            def chain():
                R = P
                for _ in range(times):
                    R = Gc._dbl_plain(R)
                return R

            entry(dbl, dbl, on, lambda: kdbl(Gc, P, times), chain,
                  Gc.affine_packed,
                  *point_work(L, comps, 6, dbl_muls * times, lanes),
                  {"lanes": lanes, "times": times})

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
         "curve's main and msm paths' runs")


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
    phase_golden(dev)
    phase_golden(dev, BLS)
    phase_oracle(dev, BN158)
    curve_paths = {}
    for curve in ("BN254", BLS, BN158):
        launches, shapes, state = phase_main(dev, card, curve)
        label, sfx = LABEL[curve]
        curve_paths[curve] = {label: (launches, shapes),
                              "msm" + sfx: phase_msm(card, state)}
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
