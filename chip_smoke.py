#!/usr/bin/env python3
"""Card smoke run of the PyTorch/CUDA port (kzg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line with what it checked and its time; any
mismatch or exception exits non-zero before the result line):
  1. build   — compiles the port's CUDA sources with nvcc for sm_90a, one
               process each, and prints the card's name and power limit;
  2. kernels — K1 (Montgomery multiply) at 4096, 131072 and 811008 lanes on
               Fp and Fr with lazy input limbs, K2 (G1 complete add, with and
               without reset mask) and K3 (G1 doubling chain, times 1 and 8)
               over 8192 lanes with infinity, doubling and negation cases:
               each held against its plain PyTorch version on the same card
               tensors (exact equality of limbs or of canonical affine
               points) and sampled lanes against python-int arithmetic;
  3. golden  — reproduces the BN254 golden bytes of
               tests/fixtures/golden/ from the 48-term setup file, verifies
               the whole-message proof and refutes a changed byte;
  4. main    — the main path of bench.py at full size: from_secret setup of
               5000 terms (with its oracle self-check), from_blob of 4097
               characters (degree 4096), create_commit, create_proof(p, 0, 1),
               verify_proof true and a one-bit refutation false; cold times,
               warm medians and each kernel's launches on the path; then
               one warm commit, proof and verify under torch.profiler (device
               time, busy share, launches and the kernels that take the most
               device time);
  5. kernels line — each kernel held against its plain version once more at
               the heaviest shape the main path gave it, then one JSON
               object: each kernel's launches on the main path, its largest
               error against the plain version, its device time per launch,
               the plain version's time per call, and the bound at that
               shape.
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
K23_LANES = 8192
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
    return out, cold, statistics.median(warm)


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


def g1_inputs(ctx, lanes, rng):
    """Two G1 batches of `lanes` points: pool points under random projective
    rescaling, with infinity, P == Q and Q == -P lanes."""
    from kzg_tpu_torch.refmodel.model import G1
    og = G1(ctx.cp)
    pool = [og.mul(rng.randrange(1, ctx.cp.r), og.gen) for _ in range(48)]
    ip = [rng.randrange(len(pool)) for _ in range(lanes)]
    iq = [rng.randrange(len(pool)) for _ in range(lanes)]
    pts_p = [pool[i] for i in ip]
    pts_q = [pool[i] for i in iq]
    for j in range(0, lanes - 7, 8):
        pts_q[j] = pts_p[j]                              # doubling
        pts_q[j + 1] = og.neg(pts_p[j + 1])              # negation
        pts_p[j + 2] = None                              # inf + Q
        pts_q[j + 3] = None                              # P + inf
        pts_p[j + 4] = pts_q[j + 4] = None               # inf + inf
    G = ctx.g1
    F = ctx.fp

    def rescale(P):
        lam = F.encode([rng.randrange(1, F.modulus) for _ in range(lanes)])
        x, y, z = F.mul_many([(P["x"], lam), (P["y"], lam), (P["z"], lam)])
        return {"x": x, "y": y, "z": z}

    return (rescale(G.encode_points(pts_p)), rescale(G.encode_points(pts_q)),
            pts_p, pts_q, og)


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
    line("build", t0, f"nvcc sm_90a built {sorted(secs)} in parallel "
         f"({max(secs.values()) if secs else 0.0:.1f}s); card: {card}")
    return card


def phase_kernels(dev, errs):
    """Each kernel against its plain version on the same card tensors."""
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.fields.mont import limbs_to_ints
    from kzg_tpu_torch.ops import cuda
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

    # K2 / K3 ------------------------------------------------------------
    t0 = time.time()
    G = ctx.g1
    lanes = K23_LANES
    P, Q, pts_p, pts_q, og = g1_inputs(ctx, lanes, rng)
    sample = rng.sample(range(lanes), 16) + list(range(8))

    def same(A, B, what, name):
        pa, pb = G.affine_packed(A), G.affine_packed(B)
        err = (pa - pb).abs().max().item()
        errs[name] = max(errs[name], err)
        check(err == 0, f"{what}: kernel != plain (max {err})")
        return pa

    def fresh(A, what):
        for k in ("x", "y", "z"):
            check(int(A[k].max()) <= 0xFFFF, f"{what}: limbs above 16 bits")
            v = max(limbs_to_ints(A[k][:, :64]))
            check(v < G.F.modulus * 11 // 10, f"{what}: value >= 1.1p")

    k = cuda.g1_add(G, P, Q)
    fresh(k, "K2")
    got = G.unpack_affine(same(k, G._add_plain(P, Q), "K2 add", "g1_add"))
    for i in sample:
        check(got[i] == og.add(pts_p[i], pts_q[i]), f"K2 lane {i} vs oracle")
    mask = torch.rand(lanes, generator=gen, device=dev) < 0.3
    k = cuda.g1_add(G, P, Q, mask)
    fresh(k, "K2 reset")
    same(k, G.select(mask, Q, G._add_plain(P, Q)), "K2 reset mask", "g1_add")
    for times in (1, 8):
        k = cuda.g1_dbl(G, P, times)
        fresh(k, "K3")
        ref = P
        for _ in range(times):
            ref = G._dbl_plain(ref)
        got = G.unpack_affine(same(k, ref, f"K3 times={times}", "g1_dbl"))
        for i in sample:
            check(got[i] == og.mul(1 << times, pts_p[i]),
                  f"K3 times={times} lane {i} vs oracle")
    line("kernels", t0, f"K2 g1_add (with/without reset mask) and K3 g1_dbl "
         f"(times 1, 8) == plain as canonical affine points over {lanes} "
         "lanes incl. infinity/doubling/negation; outputs exact 16-bit, "
         "< 1.1p; 24 lanes vs oracle")


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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} not launched on the main path")
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
    """The main path's shape that carries the most lanes for a kernel."""
    def work(item):
        key, n = item
        lanes = key[0] * key[1] if isinstance(key, tuple) else key
        return lanes * n
    return max(shapes.items(), key=work)[0]


def phase_kernel_line(dev, launches, shapes, errs):
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda
    t0 = time.time()
    ctx = get_context("BN254", dev)
    F, G = ctx.fp, ctx.g1
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = random.Random(SEED + 1)
    out = []

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
        out.append({"name": name, "route": "cuda", "source": k.source,
                    "replaces": k.replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                    "bound_ms": b, "bound_by": by, "library_ms": None,
                    "shape": shape, "event_ms": event_ms(kernel_fn)})

    lanes = heaviest(shapes["mont_mul"])
    a, b = lazy_limbs(F, lanes, gen), lazy_limbs(F, lanes, gen)
    entry("mont_mul", lambda: cuda.mont_mul(F, a, b),
          lambda: F._mul_plain(a, b), F.canon, 3 * F.L * 8 * lanes,
          2 * MACS_PER_MUL * lanes, {"lanes": lanes})

    lanes = heaviest(shapes["g1_add"])
    P, Q, _, _, _ = g1_inputs(ctx, lanes, rng)
    entry("g1_add", lambda: cuda.g1_add(G, P, Q),
          lambda: G._add_plain(P, Q), G.affine_packed, 9 * F.L * 8 * lanes,
          15 * 2 * MACS_PER_MUL * lanes, {"lanes": lanes})

    lanes, times = heaviest(shapes["g1_dbl"])
    P, _, _, _, _ = g1_inputs(ctx, lanes, rng)

    def chain():
        R = P
        for _ in range(times):
            R = G._dbl_plain(R)
        return R

    entry("g1_dbl", lambda: cuda.g1_dbl(G, P, times), chain, G.affine_packed,
          6 * F.L * 8 * lanes, (9 * times + 3) * 2 * MACS_PER_MUL * lanes,
          {"lanes": lanes, "times": times})
    print(json.dumps({"kernels": out}), flush=True)
    line("kernels", t0, "each kernel == its plain version at the main "
         "path's heaviest shape; ms = device time per launch (CUDA events, "
         "launches queued behind a spin kernel), event_ms and plain_ms = "
         "CUDA events around back-to-back calls (host gaps included; plain "
         "= the PyTorch version on the same tensors)")


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
    errs = {"mont_mul": 0, "g1_add": 0, "g1_dbl": 0}
    phase_kernels(dev, errs)
    phase_golden(dev)
    launches, shapes = phase_main(dev, card)
    phase_kernel_line(dev, launches, shapes, errs)
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
