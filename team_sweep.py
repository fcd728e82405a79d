#!/usr/bin/env python3
"""Layouts of the lane-team kernels on one GPU: K2 (g1_add) and K3 (g1_dbl)
for G1, K4 (g2_add) and K5 (g2_dbl) for G2. For each (threads per team,
warps per block) both kernels of the group run the team block built for
that layout (kzg_tpu_torch/ops/team.py), are held exactly against their
plain versions and timed (device time per launch, chip_smoke.kernel_ms) at
widths the main and msm paths launch.

    python3 team_sweep.py [g1|g2] [T,W ...]
        (default: g1 with 3,2 4,2 4,4 6,2 6,4 8,2 16,2;
         g2 with 6,2 8,2 8,4 12,2 16,2)

Prints the card, the ptxas lines of g1_ops and g2_ops and their nvcc
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
DEFAULT = {"g1": [(3, 2), (4, 2), (4, 4), (6, 2), (6, 4), (8, 2), (16, 2)],
           "g2": [(6, 2), (8, 2), (8, 4), (12, 2), (16, 2)]}


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
    secs = cuda.build(["g1_ops", "g2_ops"])
    card = cs.smi()
    print(card, flush=True)
    for name in ("g1_ops", "g2_ops"):
        for ln in cuda.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln or "stack" in ln:
                print(f"[build] {name}: {ln.strip()}")
    print(f"[build] nvcc seconds {secs}", flush=True)
    ctx = get_context("BN254", dev)
    G = ctx.g2 if grp == "g2" else ctx.g1
    inputs = cs.g2_inputs if grp == "g2" else cs.g1_inputs
    add = cuda.g2_add if grp == "g2" else cuda.g1_add
    dbl = cuda.g2_dbl if grp == "g2" else cuda.g1_dbl
    P0, Q0, _, _, _ = inputs(ctx, cs.K23_LANES, random.Random(cs.SEED))
    want = {}
    for lanes in ADD_LANES:
        P, Q = cs.tiled(P0, lanes), cs.tiled(Q0, lanes)
        want[lanes] = G.affine_packed(G._add_plain(P, Q))
    for lanes, times in DBL_SHAPES:
        R = cs.tiled(P0, lanes)
        for _ in range(times):
            R = G._dbl_plain(R)
        want[(lanes, times)] = G.affine_packed(R)
    consts = cuda._g2_consts(G) if G.is_fp2 else cuda._g1_consts(G)
    prefix = consts[:len(consts) - len(team.block(G))]
    for tw in layouts:
        G._kernel_consts = cuda._u32(prefix + team.block(G, (tw, tw)))
        words = team.table(G, (tw, tw))
        row = {"group": grp, "team": tw[0], "warps": tw[1],
               "slots": [words[2], words[5]], "rounds": team.rounds(words),
               "add": {}, "dbl": {}}
        for lanes in ADD_LANES:
            P, Q = cs.tiled(P0, lanes), cs.tiled(Q0, lanes)
            err = (G.affine_packed(add(G, P, Q))
                   - want[lanes]).abs().max().item()
            cs.check(err == 0, f"{grp} add {tw} lanes={lanes}: kernel != "
                     f"plain (max {err})")
            row["add"][lanes] = cs.kernel_ms(lambda: add(G, P, Q))
        for lanes, times in DBL_SHAPES:
            P = cs.tiled(P0, lanes)
            err = (G.affine_packed(dbl(G, P, times))
                   - want[(lanes, times)]).abs().max().item()
            cs.check(err == 0, f"{grp} dbl {tw} {lanes}x{times}: kernel != "
                     f"plain (max {err})")
            row["dbl"][f"{lanes}x{times}"] = cs.kernel_ms(
                lambda: dbl(G, P, times))
        print(json.dumps({"layout": row, "card": card}), flush=True)
    G._kernel_consts = cuda._u32(consts)
    print(json.dumps({"shipped": team.LAYOUT,
                      "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
