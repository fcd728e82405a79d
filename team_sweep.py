#!/usr/bin/env python3
"""Layouts of the lane-team kernels on one GPU: K2 (g1_add) and K3 (g1_dbl)
for G1, K4 (g2_add) and K5 (g2_dbl) for G2, K6 (merge_combine_g1 /
_g2, which runs in the add's layout), or K1 (mont_mul's lane-team
variant). For each (threads per team, warps per block) the group's
kernels run the team block built for that layout
(kzg_tpu_torch/ops/team.py), are held exactly against their plain
versions and timed (device time per launch, chip_smoke.kernel_ms) at
widths the main and msm paths launch (K6: the 13 levels of a 4097-point
merge msm, 32 x 1 to 32 x 4096 lanes). K1 runs the team table of each
layout (kzg_tpu_torch/ops/k1_team.py) at 17, 25 and 11 limbs (BN254's,
BLS12-381's and BN158's Fp, lazy limbs up to 2^22, the last 64 lanes at
the point formulas' widest operands on BLS12-381 and BN158) at
K1_WIDTHS, beside the thread-per-lane variant and an empty kernel on its
grid (floor_ms) at the same widths, each exact against
Field._mul_plain; it prints, per limb count, the layout of the least
summed time below 16384 lanes and the widths at which the thread-per-lane
variant is as fast.

    python3 team_sweep.py [g1|g2|merge|merge-g2|k1] [T,W ...]
        (default: g1 with 3,2 4,2 4,4 6,2 6,4 8,2 16,2;
         g2 with 6,2 8,2 8,4 12,2 16,2; merge with 3,2 6,2 6,4;
         merge-g2 with 8,2 8,4 16,2; k1 with 4,4 8,1 8,2 8,4 16,2
         16,4 32,1 32,2)

Prints the card, the ptxas lines of the sources it builds and their nvcc
times, then one JSON line per layout and the layouts the package ships
(team.LAYOUT). Imports nothing of JAX.
"""

import json
import random
import sys
import time

import torch

import chip_smoke as cs

ADD_LANES = (1, 32, 512, 2048, 5000, 80000)
DBL_SHAPES = ((1, 8), (32, 8), (5000, 8))
MERGE_LANES = tuple(32 << j for j in range(13))
# K1: the pairing's stacked Fp2 products (108 lanes a pair), the NTT
# butterflies, the subproduct trees' widths, up to BN254's Karatsuba batch
K1_WIDTHS = (1, 36, 108, 216, 648, 1024, 2048, 4096, 8192, 12288, 16384,
             24576, 32768, 65536, 131072, 262144, 1048576)
K1_NARROW = 16384
DEFAULT = {"k1": [(4, 4), (8, 1), (8, 2), (8, 4), (16, 2), (16, 4), (32, 1),
                  (32, 2)],
           "g1": [(3, 2), (4, 2), (4, 4), (6, 2), (6, 4), (8, 2), (16, 2)],
           "g2": [(6, 2), (8, 2), (8, 4), (12, 2), (16, 2)],
           "merge": [(3, 2), (6, 2), (6, 4)],
           "merge-g2": [(8, 2), (8, 4), (16, 2)]}


def main(argv):
    if not torch.cuda.is_available():
        print("team_sweep: no CUDA device", file=sys.stderr)
        return 2
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda, team
    grp = argv[0] if argv and argv[0] in DEFAULT else "g1"
    argv = argv[1:] if argv and argv[0] in DEFAULT else argv
    layouts = [tuple(int(v) for v in a.split(",")) for a in argv] or \
        DEFAULT[grp]
    dev = torch.device("cuda", 0)
    t0 = time.time()
    if grp == "k1":
        return sweep_k1(dev, layouts, t0)
    merge = grp.startswith("merge")
    libs = ["msm_merge"] if merge else ["g1_ops", "g2_ops"]
    secs = cuda.build(libs)
    card = cs.smi()
    print(card, flush=True)
    for name in libs:
        for ln in cuda.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln or "stack" in ln:
                print(f"[build] {name}: {ln.strip()}")
    print(f"[build] nvcc seconds {secs}", flush=True)
    ctx = get_context("BN254", dev)
    g2 = grp.endswith("g2")
    G = ctx.g2 if g2 else ctx.g1
    inputs = cs.g2_inputs if g2 else cs.g1_inputs
    P0, Q0, _, _, _ = inputs(ctx, cs.K23_LANES, random.Random(cs.SEED))
    consts = cuda._g2_consts(G) if g2 else cuda._g1_consts(G)
    prefix = consts[:len(consts) - len(team.block(G))]
    timed = (sweep_merge if merge else sweep_ops)(ctx, G, P0, Q0)
    for tw in layouts:
        G._kernel_consts = cuda._u32(prefix + team.block(G, (tw, tw, tw)))
        words = team.table(G, (tw, tw, tw))
        row = {"group": grp, "team": tw[0], "warps": tw[1],
               "slots": [words[2], words[5]], "rounds": team.rounds(words),
               **timed(tw)}
        print(json.dumps({"layout": row, "card": card}), flush=True)
    G._kernel_consts = cuda._u32(consts)
    print(json.dumps({"shipped": team.LAYOUT,
                      "seconds": time.time() - t0}), flush=True)
    return 0


def sweep_k1(dev, layouts, t0):
    """K1's lane-team variant under each layout, and the thread-per-lane
    variant, at K1_WIDTHS on the Fp of BN254, BLS12-381 and BN158."""
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda, k1_team
    secs = cuda.build(["mont_mul"], cuda.LIMBS)
    card = cs.smi()
    print(card, flush=True)
    for L in cuda.LIMBS:
        for ln in cuda.build_log("mont_mul", L).splitlines():
            if "registers" in ln or "spill" in ln or "stack" in ln:
                print(f"[build] mont_mul L={L}: {ln.strip()}")
    print(f"[build] nvcc seconds {secs}", flush=True)
    picks = {}
    for curve in ("BN254", cs.BLS, cs.BN158):
        F = get_context(curve, dev).fp
        L = F.L
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        n = max(K1_WIDTHS)
        a0, b0 = cs.lazy_limbs(F, n, gen), cs.lazy_limbs(F, n, gen)
        if curve != "BN254":
            a0[:, -64:], b0[:, -64:] = cs.wide_operands(
                curve, F, 64, random.Random(cs.SEED))
        ops = {}
        for w in K1_WIDTHS:      # the first w - 64 lanes, then the wide 64
            sl = torch.cat([torch.arange(max(w - 64, 0)),
                            torch.arange(n - min(w, 64), n)]).to(dev)
            a, b = a0[:, sl].contiguous(), b0[:, sl].contiguous()
            ops[w] = (a, b, F._mul_plain(a, b))

        def timed(team):
            row = {}
            for w, (a, b, want) in ops.items():
                err = (cuda.mont_mul(F, a, b, team=team)
                       - want).abs().max().item()
                cs.check(err == 0, f"K1 L={L} team={team} lanes={w}: "
                         f"kernel != plain (max {err})")
                row[w] = cs.kernel_ms(
                    lambda: cuda.mont_mul(F, a, b, team=team))
            return row

        lane = timed(False)
        floor = {w: cs.kernel_ms(lambda: cuda.empty_launch(
            *cuda.k1_grid(L, w, team=False))) for w in K1_WIDTHS}
        print(json.dumps({"k1": {"limbs": L, "curve": curve,
                                 "variant": "lane", "ms": lane,
                                 "floor_ms": floor},
                          "card": card}), flush=True)
        rows = {}
        for tw in layouts:
            cuda._k1_tables[L] = cuda._u32(k1_team.table(L, tw))
            rows[tw] = timed(True)
            print(json.dumps({"k1": {
                "limbs": L, "curve": curve, "variant": "team",
                "team": tw[0], "warps": tw[1],
                "columns": k1_team.columns(L, tw[0]), "ms": rows[tw]},
                "card": card}), flush=True)
        cuda._k1_tables.pop(L)
        best = min(rows, key=lambda tw: sum(
            v for w, v in rows[tw].items() if w < K1_NARROW))
        picks[L] = {"layout": best, "lane_as_fast_from": [
            w for w in K1_WIDTHS if lane[w] <= rows[best][w]]}
    print(json.dumps({"k1_picks": picks, "shipped": {
        "layout": k1_team.LAYOUT, "team_below": cuda.K1_TEAM_BELOW},
        "seconds": time.time() - t0}), flush=True)
    return 0


def sweep_ops(ctx, G, P0, Q0):
    """K2/K3 or K4/K5: the plain results, and a function that holds both
    kernels against them under the layout uploaded and times them."""
    from kzg_tpu_torch.ops import cuda
    grp = "g2" if G.is_fp2 else "g1"
    add, dbl = getattr(cuda, f"{grp}_add"), getattr(cuda, f"{grp}_dbl")
    want = {}
    for lanes in ADD_LANES:
        P, Q = cs.tiled(P0, lanes), cs.tiled(Q0, lanes)
        want[lanes] = G.affine_packed(G._add_plain(P, Q))
    for lanes, times in DBL_SHAPES:
        R = cs.tiled(P0, lanes)
        for _ in range(times):
            R = G._dbl_plain(R)
        want[(lanes, times)] = G.affine_packed(R)

    def row(tw):
        out = {"add": {}, "dbl": {}}
        for lanes in ADD_LANES:
            P, Q = cs.tiled(P0, lanes), cs.tiled(Q0, lanes)
            err = (G.affine_packed(add(G, P, Q))
                   - want[lanes]).abs().max().item()
            cs.check(err == 0, f"{grp} add {tw} lanes={lanes}: kernel != "
                     f"plain (max {err})")
            out["add"][lanes] = cs.kernel_ms(lambda: add(G, P, Q))
        for lanes, times in DBL_SHAPES:
            P = cs.tiled(P0, lanes)
            err = (G.affine_packed(dbl(G, P, times))
                   - want[(lanes, times)]).abs().max().item()
            cs.check(err == 0, f"{grp} dbl {tw} {lanes}x{times}: kernel != "
                     f"plain (max {err})")
            out["dbl"][f"{lanes}x{times}"] = cs.kernel_ms(
                lambda: dbl(G, P, times))
        return out

    return row


def sweep_merge(ctx, G, P0, Q0):
    """K6: the plain results, and a function that holds it against
    MSMEngine._combine_plain (canonical affine points of its three
    outputs, random masks) under the layout uploaded and times it at every
    merge level's width."""
    from kzg_tpu_torch.ops import cuda
    from kzg_tpu_torch.ops.msm import MSMEngine
    eng = MSMEngine(G, ctx.fr, ctx.cp.r, strategy="merge")
    gen = torch.Generator(device=P0["x"].device).manual_seed(cs.SEED)
    ops, want = {}, {}
    for lanes in MERGE_LANES:
        ops[lanes] = cs.merge_inputs(P0, Q0, lanes, gen)
        aL, aR, bL, bR, masks = ops[lanes]
        want[lanes] = torch.cat([G.affine_packed(P) for P in
                                 eng._combine_plain(aL, aR, bL, bR, *masks)],
                                dim=-1)

    def row(tw):
        out = {"merge": {}}
        for lanes in MERGE_LANES:
            aL, aR, bL, bR, masks = ops[lanes]
            got = torch.cat([G.affine_packed(P) for P in cuda.merge_combine(
                G, aL, aR, bL, bR, *masks)], dim=-1)
            err = (got - want[lanes]).abs().max().item()
            cs.check(err == 0, f"merge {tw} lanes={lanes}: kernel != plain "
                     f"(max {err})")
            out["merge"][lanes] = cs.kernel_ms(
                lambda: cuda.merge_combine(G, aL, aR, bL, bR, *masks))
        return out

    return row


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
