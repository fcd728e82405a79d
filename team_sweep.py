#!/usr/bin/env python3
"""Layouts of the lane-team kernels on one GPU: K2 (g1_add) and K3 (g1_dbl)
for G1, K4 (g2_add) and K5 (g2_dbl) for G2, K6 (merge_combine_g1 /
_g2, which runs in the add's layout), or K1 (mont_mul's lane-team
variant). For each (threads per team, warps per block) the group's
kernels run the team block built for that layout
(kzg_tpu_torch/ops/team.py), are held exactly against their plain
versions and timed (device time per launch, chip_smoke.kernel_ms) at
widths the main and msm paths launch (K6: the 13 levels of a 4097-point
merge msm, 32 x 1 to 32 x 4096 lanes). `--limbs 25` (or 11) runs the G1
or G2 kernels of BLS12-381 (BN158) instead of BN254's 17 limbs; a layout
of three numbers (threads per team, warps per block, ranks per product)
runs K2/K3 or K4/K5 on the split executor (team.split_block), and then the
sweep also times the shipped lane layouts (team.LAYOUT) at the same
widths, gives each layout's summed time below the shipped width rule
(below_rule_ms) and prints, per kernel, the split layout of the least
summed time below NARROW lanes and the widths at which the lane executor
is as fast (split_picks); each split layout's row also holds its doubling
at 1 lane with times = 1, 2, 4, 8 and the least-squares line through them
(`fit`: the intercept, what a launch spends besides its doublings, and the
slope, ms a doubling). `--paths FILE` weights the picks by the paths:
FILE holds the launch shapes of the curve's paths as chip_smoke.py's
sweep weighs them (main and msm; on BN254, at 17 limbs, multiproof too),
from chip_smoke.py's phases (run here, at full size, and written to FILE
with a hash of the package's Python sources and chip_smoke.py, run again
when FILE is missing or its hash is not the tree's); the sweep then also
times every shape the paths launch, and `weighted_picks` gives, per
kernel, the split layout whose path time (sum over the paths' shapes of
launches x min(split, lane) ms) is least, beside the unweighted pick.
K1 runs the team table of each layout (kzg_tpu_torch/ops/k1_team.py) at
17, 25 and 11 limbs (BN254's, BLS12-381's and BN158's Fp, lazy limbs up
to 2^22, the last 64 lanes at the point formulas' widest operands on
BLS12-381 and BN158) at K1_WIDTHS, beside the thread-per-lane variant and an empty kernel on its
grid (floor_ms) at the same widths, each exact against
Field._mul_plain; it prints, per limb count, the layout of the least
summed time below 16384 lanes and the widths at which the thread-per-lane
variant is as fast.

    python3 team_sweep.py [g1|g2|merge|merge-g2|k1] [--limbs L]
                          [--paths FILE] [T,W ... | T,W,R ...]
    python3 team_sweep.py sass [--limbs L]
    python3 team_sweep.py fixed
    (each also with --csrc DIR: the kernels built from the sources in DIR,
     a copy of kzg_tpu_torch/csrc with a change to try, instead)
        (default: g1 with 3,2 4,2 4,4 6,2 6,4 8,2 16,2, at 17, 25 and
         11 limbs given with --limbs the split layouts
         SPLIT_DEFAULT["g1", L]; g2 with 6,2 8,2 8,4 12,2 16,2, with
         --limbs SPLIT_DEFAULT["g2", L]; merge
         with 3,2 6,2 6,4;
         merge-g2 with 8,2 8,4 16,2; k1 with 4,4 8,1 8,2 8,4 16,2
         16,4 32,1 32,2)

Prints the card, the ptxas lines of the sources it builds and their nvcc
times, then one JSON line per layout and the layouts the package ships
(team.LAYOUT). `sass` builds msm_merge at L limbs (default 25) and
prints, per kernel of the library, the counts of its multiply and add
opcodes in `cuobjdump -sass` (a K6 kernel holds one inlined product:
mont_mul's, or at the limb counts of team.MERGE_DIGITS mont_mul_d32's).
`fixed` runs chip_smoke.py's split fit alone: K3 and K5 at 25, 11 and 17
limbs on the shipped split layouts at 1 lane, times = 1, 2, 4, 8, each
exact, with the least-squares intercept and slope. Imports nothing of
JAX.
"""

import collections
import hashlib
import json
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs

ADD_LANES = (1, 32, 512, 2048, 5000, 80000)
DBL_SHAPES = ((1, 8), (32, 8), (5000, 8))
# K2-K5 on the split executor: the widths around the width rule too
SPLIT_ADD_LANES = (1, 32, 128, 256, 512, 544, 576, 640, 704, 768, 1024,
                   1056, 1536, 2048, 4096, 5000, 8192, 10000, 20000)
# (every 32 lanes from 384 to 1024 brackets the doublings' rules, where a
# second wave of split blocks starts)
SPLIT_DBL_SHAPES = (((1, 8), (32, 8), (256, 8))
                    + tuple((w, 8) for w in range(384, 1025, 32))
                    + ((1536, 8), (2048, 8), (3072, 8), (4097, 8), (5000, 8),
                       (10000, 8)))
FIT_TIMES = (1, 2, 4, 8)             # the doubling at 1 lane, for `fit`
NARROW = 8192
# Per group and limb count. At 25 limbs, G1: whole-block teams of 6
# products a round (3 rounds an add), of 4 and 8 (a doubling's widest level
# has 4), and one-warp teams of 4 products a round, W lanes a block; G2: 16
# products a round and its neighbours. At 11 limbs (22 product columns:
# R = 8 gives 3 a rank, R = 16 2), the same kinds of team with more
# products a round of 8 and 16 ranks. At 17 limbs (34 columns: R = 8 gives
# 5 a rank, R = 16 3, R = 32 2), G2 teams of 64-288 threads at each R, G1
# one-warp teams and whole-block teams of 3-6 products a round
SPLIT_DEFAULT = {
    ("g1", 25): [(96, 3, 16), (192, 6, 32), (192, 6, 16), (64, 2, 16),
                 (128, 4, 32), (128, 4, 16), (32, 1, 8), (32, 2, 8),
                 (32, 4, 8), (32, 8, 8)],
    ("g2", 25): [(64, 2, 16), (128, 4, 16), (192, 6, 16), (256, 8, 8),
                 (256, 8, 16), (256, 8, 32), (288, 9, 16)],
    ("g1", 11): [(32, 1, 8), (32, 2, 8), (32, 4, 8), (32, 8, 8), (64, 2, 8),
                 (96, 3, 8), (96, 3, 16), (192, 6, 16), (192, 6, 32),
                 (64, 2, 16)],
    ("g2", 11): [(128, 4, 8), (256, 8, 8), (256, 8, 16), (64, 2, 8),
                 (128, 4, 16), (64, 2, 16)],
    ("g1", 17): [(32, 1, 8), (32, 2, 8), (32, 4, 8), (32, 8, 8),
                 (96, 3, 32), (128, 4, 32), (192, 6, 32), (64, 2, 16),
                 (96, 3, 16), (192, 6, 16)],
    ("g2", 17): [(64, 2, 8), (64, 2, 16), (128, 4, 8), (128, 4, 16),
                 (128, 4, 32), (256, 8, 8), (256, 8, 16), (256, 8, 32),
                 (288, 9, 16), (288, 9, 32)]}
CURVES = {17: "BN254", 25: cs.BLS, 11: cs.BN158}
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
    if "--csrc" in argv:         # build the kernels from another source tree
        at = argv.index("--csrc")
        cuda.CSRC = Path(argv[at + 1]).resolve()
        argv = argv[:at] + argv[at + 2:]
    if argv[:1] == ["sass"]:
        return sass_counts(int(argv[2]) if argv[1:2] == ["--limbs"] else 25)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    if argv[:1] == ["fixed"]:
        return fixed(dev, t0)
    grp = argv[0] if argv and argv[0] in DEFAULT else "g1"
    argv = argv[1:] if argv and argv[0] in DEFAULT else argv
    L, split_default = cuda.BASE_L, {}
    if argv[:1] == ["--limbs"]:
        L, argv, split_default = int(argv[1]), argv[2:], SPLIT_DEFAULT
    paths = None
    if argv[:1] == ["--paths"]:
        paths, argv = argv[1], argv[2:]
    layouts = ([tuple(int(v) for v in a.split(",")) for a in argv]
               or split_default.get((grp, L), DEFAULT[grp]))
    if grp == "k1":
        return sweep_k1(dev, layouts, t0)
    merge = grp.startswith("merge")
    libs = ["msm_merge"] if merge else ["g1_ops", "g2_ops"]
    secs = cuda.build(libs, (L,))
    card = cs.smi()
    print(card, flush=True)
    for name in libs:
        for ln in cs.ptxas_lines(cuda.build_log(name, L)):
            print(f"[build] {cuda.kernel_key(name, L)}: {ln}")
    print(f"[build] nvcc seconds {secs}", flush=True)
    g2 = grp.endswith("g2")
    weights = path_weights(dev, card, L, g2, paths) if paths else None
    ctx = get_context(CURVES[L], dev)
    G = ctx.g2 if g2 else ctx.g1
    inputs = cs.g2_inputs if g2 else cs.g1_inputs
    P0, Q0, _, _, _ = inputs(ctx, cs.K23_LANES, random.Random(cs.SEED))
    consts = cuda._g2_consts(G) if g2 else cuda._g1_consts(G)
    prefix = consts[:len(consts) - len(team.block(G))]
    split = any(len(tw) == 3 for tw in layouts)
    if merge:
        timed = sweep_merge(ctx, G, P0, Q0)
    else:
        timed = sweep_ops(ctx, G, P0, Q0, split, weights)
    rows = {}
    if split:                    # the shipped lane layouts beside them
        layouts = ["lane"] + layouts
    for tw in layouts:
        if tw == "lane":
            G._kernel_consts = cuda._u32(consts)
            words = team.table(G)
        elif len(tw) == 3:
            G._kernel_split_consts = cuda._u32(
                prefix + team.split_block(G, (tw, tw)))
            words = team.split_table(G, (tw, tw))
        else:
            G._kernel_consts = cuda._u32(prefix + team.block(G, (tw, tw, tw)))
            words = team.table(G, (tw, tw, tw))
        rows[tw] = timed(tw, (tw != "lane" and len(tw) == 3) if split
                         else None)
        row = {"group": grp, "limbs": L, "team": words[0],
               "warps": words[1], "ranks": words[team.RANKS],
               "dbl_layout": words[3:5], "slots": [words[2], words[5]],
               "rounds": team.rounds(words), **rows[tw]}
        if split:
            row["below_rule_ms"] = below_rule(rows[tw], grp, L)
        print(json.dumps({"layout": row, "card": card}), flush=True)
    G._kernel_consts = cuda._u32(consts)
    G._kernel_split_consts = None
    if split:
        print(json.dumps({"split_picks": split_picks(rows, "lane"),
                          "group": grp, "card": card}), flush=True)
    if split and weights:
        print(json.dumps({"weighted_picks": split_picks(rows, "lane",
                                                        weights),
                          "weights": weights, "group": grp, "card": card}),
              flush=True)
    print(json.dumps({"shipped": {"layout": team.LAYOUT,
                                  "split_layout": team.SPLIT_LAYOUT,
                                  "split_below": cuda.SPLIT_BELOW},
                      "seconds": time.time() - t0}), flush=True)
    return 0


def path_weights(dev, card, L, g2, path):
    """{"add": {lanes: launches}, "dbl": {"LANESxTIMES": launches}} of the
    group's K2/K3 (or K4/K5) on the paths of the curve at L limbs that
    chip_smoke.py sweeps, summed over them: main and msm, and at 17 limbs
    (BN254) multiproof too. Read from the JSON file `path` where it was
    written from the sources it names (source_hash), else taken from
    chip_smoke.py's phase_main, phase_msm (and phase_multiproof) run here
    (every source built at L) and written there."""
    from kzg_tpu_torch.ops import cuda
    f = Path(path)
    saved = json.loads(f.read_text()) if f.exists() else {}
    if saved.get("source") != source_hash():
        cuda.build(limbs=(L,))
        _, shapes, state = cs.phase_main(dev, card, CURVES[L])
        every = [shapes, cs.phase_msm(card, state)[1]]
        if L == cuda.BASE_L:
            every.append(cs.phase_multiproof(card, state,
                                             cs.main_message())[1])
        out = {}
        for shp in every:
            for key, d in shp.items():
                for k, n in d.items():
                    k = "x".join(map(str, k)) if isinstance(k, tuple) else k
                    out.setdefault(key, {})
                    out[key][str(k)] = out[key].get(str(k), 0) + n
        f.parent.mkdir(parents=True, exist_ok=True)
        saved = {"source": source_hash(), "shapes": out}
        f.write_text(json.dumps(saved))
    shapes = saved["shapes"]
    grp = "g2" if g2 else "g1"
    return {"add": {int(k): n for k, n in shapes.get(
                cuda.kernel_key(f"{grp}_add", L), {}).items()},
            "dbl": dict(shapes.get(cuda.kernel_key(f"{grp}_dbl", L), {}))}


def source_hash():
    """sha256 of the files that decide the paths' launch shapes: the
    package's Python sources and chip_smoke.py."""
    root = Path(__file__).resolve().parent
    h = hashlib.sha256()
    for f in sorted(root.glob("kzg_tpu_torch/**/*.py")) + [
            root / "chip_smoke.py"]:
        h.update(str(f.relative_to(root)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def fixed(dev, t0):
    """chip_smoke.py's split fit alone, with the builds it needs."""
    from kzg_tpu_torch.ops import cuda
    secs = cuda.build(["g1_ops", "g2_ops"], cs.FIT_LIMBS)
    card = cs.smi()
    print(card, flush=True)
    for L in cs.FIT_LIMBS:
        for name in ("g1_ops", "g2_ops"):
            for ln in cs.ptxas_lines(cuda.build_log(name, L)):
                print(f"[build] {cuda.kernel_key(name, L)}: {ln}")
    print(f"[build] nvcc seconds {secs}", flush=True)
    errs = collections.defaultdict(int)
    print(json.dumps({"split_fit": cs.split_fit(dev, errs), "card": card,
                      "seconds": time.time() - t0}), flush=True)
    return 0


def below_rule(row, grp, L):
    """Per kernel (add, dbl) of a layout's row: its summed ms at the swept
    widths below the shipped width rule of group `grp` at L limbs (NARROW
    where the rule has no entry)."""
    from kzg_tpu_torch.ops import cuda
    out = {}
    for kern in ("add", "dbl"):
        rule = cuda.SPLIT_BELOW[f"{grp}_{kern}"].get(L, NARROW)
        out[kern] = sum(ms for w, ms in row[kern].items()
                        if int(str(w).split("x")[0]) < rule)
    return out


def split_picks(rows, lane, weights=None):
    """Per kernel (add, dbl): the split layout whose shipping below the
    widths where the lane executor (row `lane`) is as fast costs least,
    summed over the swept widths below NARROW lanes (sum of min(split,
    lane) ms), that sum, the lane executor's alone, and the widths at
    which the lane executor is as fast as the pick. With `weights`
    ({kernel: {width: launches}}, path_weights) each width's term is
    weighted by its launches on the paths, over the paths' widths alone:
    the paths' time in the kernel."""
    picks = {}
    for kern in ("add", "dbl"):
        if weights is None:
            w_of = {w: 1 for w in rows[lane][kern]
                    if int(str(w).split("x")[0]) < NARROW}
        else:
            w_of = weights[kern]

        def cost(tw):
            return sum(n * min(rows[tw][kern][w], rows[lane][kern][w])
                       for w, n in w_of.items())
        best = min((tw for tw in rows if tw != lane and len(tw) == 3),
                   key=cost)
        picks[kern] = {
            "layout": best, "split_sum_ms": cost(best),
            "lane_sum_ms": sum(n * rows[lane][kern][w]
                               for w, n in w_of.items()),
            "lane_as_fast_from": [w for w, ms in rows[lane][kern].items()
                                  if ms <= rows[best][kern][w]]}
    return picks


SASS_OPS = ("IMAD", "IMAD.WIDE", "IMAD.HI", "IMAD.X", "IMAD.MOV",
            "IMAD.SHL", "IMAD.IADD", "IADD3", "IADD3.X", "LEA", "SHF",
            "LOP3", "PRMT")


def sass_counts(L):
    """cuobjdump -sass of msm_merge at L limbs: per kernel, the count of
    each opcode of SASS_OPS (an opcode counts under the longest of them
    that its name starts with, `.U32` and the like dropped) and of all
    instructions."""
    from kzg_tpu_torch.ops import cuda
    cuda.build(["msm_merge"], (L,))
    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(cuda._so_path(
        "msm_merge", L))], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = cs.kernel_name(m.group(1))
            counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if fn and m:
            op = m.group(1)
            counts[fn]["all"] += 1
            hit = [k for k in SASS_OPS if op == k or op.startswith(k + ".")]
            if hit:
                counts[fn][max(hit, key=len)] += 1
    print(json.dumps({"sass": {"limbs": L, "tool": str(tool),
                               "kernels": counts}}), flush=True)
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
        for ln in cs.ptxas_lines(cuda.build_log("mont_mul", L)):
            print(f"[build] mont_mul L={L}: {ln}")
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


def sweep_ops(ctx, G, P0, Q0, split=False, weights=None):
    """K2/K3 or K4/K5: the plain results, and a function that holds both
    kernels against them under the layout uploaded, on the variant `team`
    (True the split executor, False the lane one; None the width rule),
    and times them; with `split`, at the split widths, and the doubling at
    1 lane at FIT_TIMES with its least-squares line (`fit`); with
    `weights` (path_weights), at the paths' widths too."""
    from kzg_tpu_torch.ops import cuda
    grp = "g2" if G.is_fp2 else "g1"
    add, dbl = getattr(cuda, f"{grp}_add"), getattr(cuda, f"{grp}_dbl")
    add_lanes = SPLIT_ADD_LANES if split else ADD_LANES
    dbl_shapes = SPLIT_DBL_SHAPES if split else DBL_SHAPES
    if weights:
        add_lanes = sorted(set(add_lanes) | set(weights["add"]))
        dbl_shapes = sorted(set(dbl_shapes) | {
            tuple(map(int, k.split("x"))) for k in weights["dbl"]})
    fit_shapes = [(1, t) for t in FIT_TIMES] if split else []
    want = {}
    for lanes in add_lanes:
        P, Q = cs.tiled(P0, lanes), cs.tiled(Q0, lanes)
        want[lanes] = G.affine_packed(G._add_plain(P, Q))
    for lanes, times in sorted(set(dbl_shapes) | set(fit_shapes)):
        R = cs.tiled(P0, lanes)
        for _ in range(times):
            R = G._dbl_plain(R)
        want[(lanes, times)] = G.affine_packed(R)

    def dbl_ms(tw, lanes, times, kw):
        P = cs.tiled(P0, lanes)
        err = (G.affine_packed(dbl(G, P, times, **kw))
               - want[(lanes, times)]).abs().max().item()
        cs.check(err == 0, f"{grp} dbl {tw} {lanes}x{times}: kernel != "
                 f"plain (max {err})")
        return cs.kernel_ms(lambda: dbl(G, P, times, **kw))

    def row(tw, team=None):
        kw = {} if team is None else {"team": team}
        out = {"add": {}, "dbl": {}}
        for lanes in add_lanes:
            P, Q = cs.tiled(P0, lanes), cs.tiled(Q0, lanes)
            err = (G.affine_packed(add(G, P, Q, **kw))
                   - want[lanes]).abs().max().item()
            cs.check(err == 0, f"{grp} add {tw} lanes={lanes}: kernel != "
                     f"plain (max {err})")
            out["add"][lanes] = cs.kernel_ms(lambda: add(G, P, Q, **kw))
        for lanes, times in dbl_shapes:
            out["dbl"][f"{lanes}x{times}"] = dbl_ms(tw, lanes, times, kw)
        if fit_shapes:
            ms = {t: dbl_ms(tw, 1, t, kw) for _, t in fit_shapes}
            slope, icpt = statistics.linear_regression(list(ms),
                                                       list(ms.values()))
            out["fit"] = {"ms": ms, "intercept_ms": icpt, "slope_ms": slope}
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

    def row(tw, team=None):
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
