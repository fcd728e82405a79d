#!/usr/bin/env python3
"""Card smoke run of the PyTorch/CUDA port (kzg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line with what it checked and its time; any
mismatch or exception exits non-zero before the result line):
  1. build   — compiles the port's CUDA sources with nvcc for sm_90a, one
               process each, all started together, prints each kernel's
               ptxas register and spill lines and the card's name and power
               limit;
  2. kernels — K1 (Montgomery multiply) at 4096, 131072 and 811008 lanes on
               Fp and Fr with lazy input limbs; K2/K4 (G1/G2 complete add,
               with and without reset mask) and K3/K5 (G1/G2 doubling chain,
               times 1 and 8) over 8200 lanes with infinity, doubling and
               negation cases, K2-K5 again at the ragged widths of their
               lane teams (1, 5, 31, 32, 33, 127, 8193 lanes); K6 (merge
               combine, G1 and G2) over 8200 lanes with random masks: each
               held against its plain PyTorch version on the same card
               tensors (exact equality of limbs or of canonical affine
               points), outputs checked fresh (exact 16-bit limbs, < 1.1p)
               and sampled lanes against python-int arithmetic;
  3. golden  — reproduces the BN254 golden bytes of
               tests/fixtures/golden/ from the 48-term setup file, verifies
               the whole-message proof and refutes a changed byte;
  4. main    — the main path of bench.py at full size: from_secret setup of
               5000 terms (with its oracle self-check), from_blob of 4097
               characters (degree 4096), create_commit, create_proof(p, 0, 1),
               verify_proof true and a one-bit refutation false; cold times,
               warm medians and each kernel's launches on the path (K1-K5
               must all run); then one warm commit, proof and verify under
               torch.profiler (device time, busy share, launches and the
               kernels that take the most device time);
  5. msm     — the merge strategy's path (msm over arbitrary bases, the
               JAX package's TPU path for msm), on the main phase's setup
               and polynomial: G1 over the first 4097 setup points equals
               the commitment, G2 over the first 4097 G2 setup points equals
               the chunked G2 msm_shifted; log and scan at 256 points equal
               chunked; cold time, warm median and launches per call (K6
               must run);
  6. kernels line — each kernel held against its plain version once more at
               the heaviest shape its path gave it, then one JSON object:
               each kernel's launches on the main and msm paths, its
               largest error against the plain version, its device time per
               launch, the plain version's time per call, and the bound at
               that shape; before it the "sweep" line: K2-K5 held
               against their plain versions and timed at every distinct
               shape the two paths launched, with each path's device time
               in the kernel (path_ms = sum of launches x ms).
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
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
EDGE_LANES = (1, 5, 31, 32, 33, 127, 8193)   # K2-K5 ragged team edges
MSM_POINTS = DEGREE + 1                  # the merge msm of the msm phase
MSM_SCAN_POINTS = 256                    # its log and scan strategies
MAIN_KERNELS = ("mont_mul", "g1_add", "g1_dbl", "g2_add", "g2_dbl")
MSM_KERNELS = ("merge_combine_g1", "merge_combine_g2")
# published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores (67 TFLOP/s, an FMA counted as two
# operations), taken as the ceiling for the kernels' integer
# multiply-accumulates (each also counted as two operations); the card's
# 32-bit integer multiply rate is lower, so this bound is optimistic
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
MACS_PER_MUL = 2 * 17 * 17 + 17          # product + reduction, per lane


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
    to ~9 * 2^256 (< 64 p for BN254) with limbs up to ~2^22 (random
    borrows of up to 63 * 2^16 from the limb above)."""
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


def fresh_points(G, A, what):
    """Kernel output coordinates: exact 16-bit limbs, each component
    < 1.1 p (first 64 lanes by value)."""
    from kzg_tpu_torch.fields.mont import limbs_to_ints
    p = G.F.base.modulus if G.is_fp2 else G.F.modulus
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
    secs = cuda.build()
    card = smi()
    for name in cuda.SOURCES:
        for ln in cuda.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}")
    line("build", t0, "nvcc sm_90a built in parallel, seconds to each "
         f"finish: { {k: round(v, 1) for k, v in secs.items()} }; card: "
         f"{card}")
    return card


def phase_kernels(dev, errs):
    """Each kernel against its plain version on the same card tensors."""
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.ops.msm import MSMEngine
    ctx = get_context("BN254", dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = random.Random(SEED)

    # K1 ---------------------------------------------------------------
    t0 = time.time()
    for F in (ctx.fp, ctx.fr):
        p = F.modulus
        rinv = pow(1 << (16 * F.L), -1, p)
        for lanes in K1_LANES:
            a = lazy_limbs(F, lanes, gen)
            b = lazy_limbs(F, lanes, gen)
            k = cuda.mont_mul(F, a, b)
            ref = F._mul_plain(a, b)
            sync()
            err = (k - ref).abs().max().item()
            errs["mont_mul"] = max(errs["mont_mul"], err)
            check(err == 0, f"K1 lanes={lanes}: kernel != plain (max {err})")
            check(int(k.max()) <= 0xFFFF, "K1 output limbs above 16 bits")
            ck, cr = F.canon(k), F.canon(ref)
            check(torch.equal(ck, cr), f"K1 lanes={lanes}: canon mismatch")
            kh, ah, bh = k.cpu(), a.cpu(), b.cpu()
            for i in [0, 1, 2] + rng.sample(range(lanes), 125):
                va, vb, vk = to_int(ah[:, i]), to_int(bh[:, i]), \
                    to_int(kh[:, i])
                check(vk < p + p // 10, f"K1 lane {i}: value >= 1.1p")
                check(vk % p == va * vb * rinv % p,
                      f"K1 lane {i}: not a*b*R^-1 mod p")
    line("kernels", t0, "K1 mont_mul == plain (bit-exact limbs, canonical "
         f"values, 128 lanes vs python ints) at {K1_LANES} lanes, Fp and Fr, "
         "lazy inputs up to 2^22 limbs")

    # K2 / K3 and K4 / K5 ------------------------------------------------
    lanes = K23_LANES
    for G, inputs, add, dbl, kadd, kdbl in (
            (ctx.g1, g1_inputs, cuda.g1_add, cuda.g1_dbl, "g1_add", "g1_dbl"),
            (ctx.g2, g2_inputs, cuda.g2_add, cuda.g2_dbl, "g2_add", "g2_dbl")):
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
        line("kernels", t0, f"{kadd} (with/without reset mask) and {kdbl} "
             f"(times 1, 8) == plain as canonical affine points over {lanes} "
             "lanes incl. infinity/doubling/negation; outputs exact 16-bit, "
             "< 1.1p; 24 lanes vs oracle")
        edge_widths(G, P, Q, pts_p, pts_q, og, gen, errs)

        # K6 on the same group: aR, bL = P, Q; aL, bR a second pair
        t0 = time.time()
        name = "merge_combine_g2" if G.is_fp2 else "merge_combine_g1"
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
        line("kernels", t0, f"{name} == plain (MSMEngine._combine_plain) as "
             f"canonical affine points over {lanes} lanes with random masks; "
             "kept lanes' limbs unchanged, mid exact 16-bit, < 1.1p")


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
    kadd, kdbl = f"{grp}_add", f"{grp}_dbl"
    add, dbl = getattr(cuda, kadd), getattr(cuda, kdbl)
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


def phase_golden(dev):
    import kzg_tpu_torch as kzg
    t0 = time.time()
    gold = os.path.join(HERE, "tests", "fixtures", "golden")
    with open(os.path.join(gold, "golden_BN254.json")) as f:
        vec = json.load(f)
    kzg.init("BN254", device=dev)
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
    line("golden", t0, f"BN254 golden poly/commit/{len(vec['proofs'])} proof "
         "bytes reproduced from the 48-term file; verify true, refutation "
         "false")


def phase_main(dev, card):
    import kzg_tpu_torch as kzg
    from kzg_tpu_torch.ops import cuda
    kzg.init("BN254", device=dev)
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
        0xBEEF_CAFE_0123, SETUP_TERMS))
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
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} not launched on the main "
              "path")
    line("main", t_all, f"setup({SETUP_TERMS}) {setup_ms:.0f} ms incl. "
         f"self-check, from_blob(deg {DEGREE}) {blob_ms:.0f} ms; verify true, "
         f"refutation false; launches {launches}")

    _, _, commit_ms = host_ms(lambda: ts.create_commit(p), WARM_RUNS)
    _, _, proof_ms = host_ms(lambda: ts.create_proof(p, 0, 1), WARM_RUNS)
    _, _, verify_ms = host_ms(lambda: ts.verify_proof(c, pr, good), WARM_RUNS)
    print(json.dumps({"main_path": {
        "card": card, "setup_ms": setup_ms, "from_blob_ms": blob_ms,
        "commit_cold_ms": commit_cold, "commit_warm_median_ms": commit_ms,
        "proof_cold_ms": proof_cold, "proof_warm_median_ms": proof_ms,
        "verify_cold_ms": verify_cold, "verify_warm_median_ms": verify_ms,
        "warm_runs": WARM_RUNS, "launches_per_op": per_op}}), flush=True)
    prof = profile_ops({"commit": lambda: ts.create_commit(p),
                        "proof": lambda: ts.create_proof(p, 0, 1),
                        "verify": lambda: ts.verify_proof(c, pr, good)})
    print(json.dumps({"profile": {"card": card, **prof}}), flush=True)
    line("main", t_all, f"card {card}: commit cold {commit_cold:.1f} / warm "
         f"{commit_ms:.1f} ms, proof cold {proof_cold:.1f} / warm "
         f"{proof_ms:.1f} ms, verify cold {verify_cold:.1f} / warm "
         f"{verify_ms:.1f} ms (median of {WARM_RUNS})")
    return launches, shapes, (ts, p, c)


def phase_msm(card, main_state):
    """The merge strategy's path: msm over arbitrary bases (Horner over the
    windows) on the main phase's setup points and polynomial. The counts
    are read around the merge msm calls alone (cold and warm runs); the
    references and decodes come after."""
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.ops.msm import MSMEngine
    from kzg_tpu_torch.protocol.api import _ctx
    ts, p, c = main_state
    pc = _ctx()
    ctx = pc.ctx
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
    for name in MSM_KERNELS:
        check(launches[name] > 0, f"kernel {name} not launched on the msm "
              "path")
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
    print(json.dumps({"msm": {"card": card, "warm_runs": WARM_RUNS, **res}}),
          flush=True)
    line("msm", t_all, f"merge msm over {n} points: G1 == commitment (cold "
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


def point_work(words, coords, muls, lanes):
    """(bytes, operations) of a point kernel over `lanes` lanes: `coords`
    coordinates of `words` int64 limbs moved and `muls` base Montgomery
    products done per lane."""
    return coords * words * 8 * lanes, muls * 2 * MACS_PER_MUL * lanes


# per group: int64 words of a coordinate, base Montgomery products of an
# add and of a doubling, and of the re-reduction after a chain. G1: an add
# does 12 products and re-reduces 3 outputs, a doubling 9. G2: an add does
# 14 Fp2 products of 3 base products and re-reduces 6 components, a
# doubling 9 Fp2 products
POINT_WORK = {"g1": (17, 15, 9, 3), "g2": (2 * 17, 48, 27, 6)}


def sweep(paths, bases, bound, errs):
    """K2-K5 at every distinct shape of the main and msm paths: each held
    against its plain version (exact canonical affine points), then its
    device time per launch (kernel_ms) and bound; per path, path_ms = sum
    over shapes of the path's launches x ms. bases: {group: (curve, P, Q)}.
    An add moves 9 coordinates, a chain 6."""
    from kzg_tpu_torch.ops import cuda
    res = {}
    for name in ("g1_add", "g1_dbl", "g2_add", "g2_dbl"):
        grp = name[:2]
        G, base_p, base_q = bases[grp]
        words, add_muls, dbl_muls, fresh_muls = POINT_WORK[grp]
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
            b, by = bound(*point_work(words, 9 if times is None else 6,
                                      add_muls if times is None
                                      else dbl_muls * times + fresh_muls,
                                      lanes))
            rows.append({"lanes": lanes, "times": times,
                         "launches_by_path": by_path, "ms": ms,
                         "bound_ms": b, "bound_by": by, "max_abs_err": err})
        res[name] = {"shapes": rows, "path_ms": path_ms}
    return res


def phase_kernel_line(dev, paths, errs):
    """paths: {path: (launches, shapes)} of the main and msm runs."""
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.ops.msm import MSMEngine
    t0 = time.time()
    ctx = get_context("BN254", dev)
    F, G, G2 = ctx.fp, ctx.g1, ctx.g2
    L = F.L
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = random.Random(SEED + 1)
    out = []
    shapes = {}
    for _, shp in paths.values():
        for name, d in shp.items():
            for key, n in d.items():
                shapes.setdefault(name, {})
                shapes[name][key] = shapes[name].get(key, 0) + n

    def bound(nbytes, ops):
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    def entry(name, kernel_fn, plain_fn, canon, nbytes, ops, shape):
        """Hold the kernel against its plain version at this shape (exact
        canonical equality), then time both."""
        k = cuda.KERNELS[name]
        a, b = canon(kernel_fn()), canon(plain_fn())
        err = (a - b).abs().max().item()
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} at {shape}: kernel != plain (max {err})")
        ms = kernel_ms(kernel_fn)
        plain = event_ms(plain_fn, iters=3)
        b, by = bound(nbytes, ops)
        by_path = {path: lc[name] for path, (lc, _) in paths.items()}
        out.append({"name": name, "route": "cuda", "source": k.source,
                    "replaces": k.replaces,
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                    "bound_ms": b, "bound_by": by, "library_ms": None,
                    "shape": shape, "event_ms": event_ms(kernel_fn)})

    def packed_all(G):
        def canon(pts):
            return torch.cat([G.affine_packed(P) for P in pts], dim=-1)
        return canon

    lanes = heaviest(shapes["mont_mul"])
    a, b = lazy_limbs(F, lanes, gen), lazy_limbs(F, lanes, gen)
    entry("mont_mul", lambda: cuda.mont_mul(F, a, b),
          lambda: F._mul_plain(a, b), F.canon, 3 * L * 8 * lanes,
          2 * MACS_PER_MUL * lanes, {"lanes": lanes})

    bases = {}
    for grp, Gc, inputs in (("g1", G, g1_inputs), ("g2", G2, g2_inputs)):
        words, add_muls, dbl_muls, fresh_muls = POINT_WORK[grp]
        add, dbl = f"{grp}_add", f"{grp}_dbl"
        kadd, kdbl = getattr(cuda, add), getattr(cuda, dbl)
        base_p, base_q, _, _, _ = inputs(ctx, K23_LANES, rng)
        bases[grp] = (Gc, base_p, base_q)
        lanes = heaviest(shapes[add])
        P, Q = tiled(base_p, lanes), tiled(base_q, lanes)
        entry(add, lambda: kadd(Gc, P, Q), lambda: Gc._add_plain(P, Q),
              Gc.affine_packed, *point_work(words, 9, add_muls, lanes),
              {"lanes": lanes})

        lanes, times = heaviest(shapes[dbl])
        P = tiled(base_p, lanes)

        def chain():
            R = P
            for _ in range(times):
                R = Gc._dbl_plain(R)
            return R

        entry(dbl, lambda: kdbl(Gc, P, times), chain, Gc.affine_packed,
              *point_work(words, 6, dbl_muls * times + fresh_muls, lanes),
              {"lanes": lanes, "times": times})

        name = f"merge_combine_{grp}"
        lanes = heaviest(shapes[name])
        aR, bL = tiled(base_p, lanes), tiled(base_q, lanes)
        aL, bR = tiled(base_q, lanes), tiled(base_p, lanes)
        aL = {k: v.roll(3, dims=-1).contiguous() for k, v in aL.items()}
        bR = {k: v.roll(5, dims=-1).contiguous() for k, v in bR.items()}
        masks = [torch.rand(lanes, generator=gen, device=dev) < 0.5
                 for _ in range(3)]
        eng = MSMEngine(Gc, ctx.fr, ctx.cp.r, strategy="merge")
        entry(name,
              lambda: cuda.merge_combine(Gc, aL, aR, bL, bR, *masks),
              lambda: eng._combine_plain(aL, aR, bL, bR, *masks),
              packed_all(Gc), (7 * 3 * words * 8 + 3) * lanes,
              add_muls * 2 * MACS_PER_MUL * lanes, {"lanes": lanes})
    print(json.dumps({"sweep": sweep(paths, bases, bound, errs)}),
          flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    line("kernels", t0, "each kernel == its plain version at the heaviest "
         "shape its path gave it; ms = device time per launch (CUDA events, "
         "launches queued behind a spin kernel), event_ms and plain_ms = "
         "CUDA events around back-to-back calls (host gaps included; plain "
         "= the PyTorch version on the same tensors); launches = the main "
         "and msm paths' runs")


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
    t_start = time.time()
    card = phase_build()
    errs = dict.fromkeys(MAIN_KERNELS + MSM_KERNELS, 0)
    phase_kernels(dev, errs)
    phase_golden(dev)
    launches, shapes, state = phase_main(dev, card)
    paths = {"main": (launches, shapes),
             "msm": phase_msm(card, state)}
    phase_kernel_line(dev, paths, errs)
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
