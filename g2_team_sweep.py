#!/usr/bin/env python3
"""Layouts of the G2 lane-team kernels K4 (g2_add) and K5 (g2_dbl) on one
GPU: for each (threads per team, warps per block) the kernels run the
schedule table built for that layout (kzg_tpu_torch/ops/g2_team.py), are
held exactly against their plain versions and timed (device time per launch,
chip_smoke.kernel_ms) at the widths the main and msm paths launch.

    python3 g2_team_sweep.py [T,W ...]     (default: 6,1 6,2 6,4 8,2 8,4 12,2
                                            16,2)

Prints the card, g2_ops' ptxas lines, then one JSON line per layout and the
layout the package ships (g2_team.TEAM, g2_team.WARPS). Imports nothing of
JAX.
"""

import json
import random
import sys
import time

import torch

import chip_smoke as cs

ADD_LANES = (1, 32, 300, 5000, 80000)
DBL_SHAPES = ((1, 8), (32, 8), (5000, 8))


def main(argv):
    if not torch.cuda.is_available():
        print("g2_team_sweep: no CUDA device", file=sys.stderr)
        return 2
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops import cuda, g2_team
    layouts = [tuple(int(v) for v in a.split(",")) for a in argv] or [
        (6, 1), (6, 2), (6, 4), (8, 2), (8, 4), (12, 2), (16, 2)]
    dev = torch.device("cuda", 0)
    t0 = time.time()
    secs = cuda.build(["g2_ops"])
    card = cs.smi()
    print(card, flush=True)
    for ln in cuda.build_log("g2_ops").splitlines():
        if "registers" in ln or "spill" in ln or "stack" in ln:
            print(f"[build] g2_ops: {ln.strip()}")
    print(f"[build] g2_ops {secs}", flush=True)
    ctx = get_context("BN254", dev)
    G = ctx.g2
    P0, Q0, _, _, _ = cs.g2_inputs(ctx, cs.K23_LANES, random.Random(cs.SEED))
    want = {}
    for lanes in ADD_LANES:
        P, Q = cs.tiled(P0, lanes), cs.tiled(Q0, lanes)
        want[lanes] = G.affine_packed(G._add_plain(P, Q))
    for lanes, times in DBL_SHAPES:
        R = cs.tiled(P0, lanes)
        for _ in range(times):
            R = G._dbl_plain(R)
        want[(lanes, times)] = G.affine_packed(R)
    shipped = getattr(G, "_kernel_consts", None)
    consts = cuda._g2_consts(G)[:-len(g2_team.table())]
    for team, warps in layouts:
        words = g2_team.table(team, warps)
        G._kernel_consts = cuda._u32(consts + list(words))
        row = {"team": team, "warps": warps, "slots": words[2],
               "rounds": g2_team.rounds(words), "add": {}, "dbl": {}}
        for lanes in ADD_LANES:
            P, Q = cs.tiled(P0, lanes), cs.tiled(Q0, lanes)
            err = (G.affine_packed(cuda.g2_add(G, P, Q))
                   - want[lanes]).abs().max().item()
            cs.check(err == 0, f"g2_add {team},{warps} lanes={lanes}: "
                     f"kernel != plain (max {err})")
            row["add"][lanes] = cs.kernel_ms(lambda: cuda.g2_add(G, P, Q))
        for lanes, times in DBL_SHAPES:
            P = cs.tiled(P0, lanes)
            err = (G.affine_packed(cuda.g2_dbl(G, P, times))
                   - want[(lanes, times)]).abs().max().item()
            cs.check(err == 0, f"g2_dbl {team},{warps} {lanes}x{times}: "
                     f"kernel != plain (max {err})")
            row["dbl"][f"{lanes}x{times}"] = cs.kernel_ms(
                lambda: cuda.g2_dbl(G, P, times))
        print(json.dumps({"layout": row, "card": card}), flush=True)
    G._kernel_consts = shipped if shipped is not None else cuda._u32(
        cuda._g2_consts(G))
    print(json.dumps({"shipped": [g2_team.TEAM, g2_team.WARPS],
                      "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
