"""The lane-team schedules of kernels K2/K3 (G1 add and doubling chain) and
K4/K5 (G2), kzg_tpu_torch.ops.team, run on the CPU.

The kernels execute the block (constant rows, then the encoded table) that
team.block() builds; team.run executes the same words with the base
field's plain ops. Here that interpreter, on a few seeded points (numpy
seed) of each group under a random projective rescaling with doubling,
negation and infinity lanes, must give the points of Curve._add_plain /
Curve._dbl_plain (equal as canonical affine arrays) and of the python-int
oracle. G2's products must see inputs inside the mul contract (value < 64
p, limbs < 2^22). G1's plain version itself goes past 64 p (its lazy
subtractions add 180 p and 194 p, and 3b (X1Z2 + X2Z1) reaches ~6 x 181
p), so there no product input may be larger, in value or limbs, than the
largest the plain version gives Field.mul, and every product a b must stay
below R p (output < 2 p). The BLS12-381 cases run the same schedules at 25
limbs (BLS12-381's Fp) with the same checks, except the G1 add's product
bound, which is larger there (test_add_schedule_matches_plain). The BN158
cases run them at 11 limbs on the other branches: G1's 3b = 39 is a
product, and G2's Fp2 has qnr = 5, whose lazy c0 = v0 + 5 v1 takes its
products past 64 p; there both groups are held to the plain version's own
product inputs and to a b < R p (BN158_AB below). test_torch_groups.py ties
the plain versions to kzg_tpu on BN254.

The split executor (below cuda.SPLIT_BELOW: K2-K5 at BLS12-381's 25
limbs and at BN158's 11, K2 and K4 at BN254's 17; each product split
over R ranks by columns, the schedule leveled for the products a round)
runs on team.split_block; the BN254 adds with the reset mask (True,
g1-True: G1 at its widest product operand, 3b (X1Z2 + X2Z1) ~1082 p),
the bls-split cases (G2), the bls-g1 cases (G1, beside the lane
executor's model) and the BN158 cases run its model (team.run with
k1_team.run's split product) at the same bounds and hold it limb for
limb against the lane executor's model, and as canonical points against
kzg_tpu's own add of the group on the same curve (jitted once per
shape): the add with the reset select, and the
doubling chain against that complete add of P + P, `times` times
(kzg_tpu's dbl would compile another ~12 s of eager JAX on a CPU, past
the port's test time budget). The wrapper's choice between the two C
entry points by width runs through a fake library
(test_g2_wrapper_picks_the_variant_by_width, every kernel of the width
rule).
"""

import ctypes
import functools
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from kzg_tpu.context import make_g1, make_g2
from kzg_tpu.curves.params import get_curve as jax_curve
from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.ops import cuda, team
from kzg_tpu_torch.refmodel.model import G1, G2

torch.set_num_threads(2)

SEED = 20261018
N = 6


@functools.lru_cache(maxsize=None)
def _batch(grp, curve="BN254"):
    ctx = get_context(curve, "cpu")
    J, og = (ctx.g2, G2(ctx.cp)) if grp == "g2" else (ctx.g1, G1(ctx.cp))
    rng = np.random.default_rng(SEED)
    pts = [og.mul(int(k), og.gen) for k in rng.integers(1, 1 << 20, N)]
    qts = [og.mul(int(k), og.gen) for k in rng.integers(1, 1 << 20, N)]
    qts[0] = pts[0]                                  # P + P
    qts[1] = og.neg(pts[1])                          # P + (-P)
    pts[2] = None                                    # inf + Q
    qts[3] = None                                    # P + inf
    pts[4] = qts[4] = None                           # inf + inf
    p = ctx.cp.p

    def rand():
        return int.from_bytes(rng.bytes(40 if p.bit_length() < 300 else 56),
                              "little") % p

    def rescaled(pp):
        P = J.encode_points(pp)
        lam = J.F.encode([(rand(), rand() or 1) if grp == "g2"
                          else rand() or 1 for _ in range(N)])
        return {k: J.F.mul(v, lam) for k, v in P.items()}

    return J, og, rescaled(pts), rescaled(qts), pts, qts


def _check_contract(stats, p, p_ratio=64, limb=1 << 22):
    assert 0 < stats["value"] < p_ratio * p
    assert 0 < stats["limb"] < limb


def _plain_stats(J, fn, monkeypatch):
    """Run the plain version fn(); record the bounds of every input that it
    gives the base field's product (team.bound_stats)."""
    F = J.F.base if J.is_fp2 else J.F
    stats = {}
    mul = F._mul_plain

    def recording(a, b):
        team.bound_stats(stats, a, b, F)
        return mul(a, b)

    with monkeypatch.context() as m:
        m.setattr(F, "_mul_plain", recording)
        out = fn()
    return out, stats


_plain_runs = {}


def _plain_once(key, J, fn, monkeypatch):
    """_plain_stats of a case's plain version, once per `key` (a split
    case shares it with the lane case of the same batch)."""
    if key not in _plain_runs:
        _plain_runs[key] = _plain_stats(J, fn, monkeypatch)
    return _plain_runs[key]


def _check_bounds(grp, J, stats, plain, ab_limit=1):
    """G2 with qnr = -1: the mul contract. G1, and G2 with qnr = 5: no
    product input above the plain version's own, in value or limbs, and a b
    < ab_limit R p for every product."""
    B = J.F.base if J.is_fp2 else J.F
    if grp == "g2" and J.F.qnr_is_m1:
        _check_contract(stats, B.modulus)
        return
    assert 0 < stats["value"] <= plain["value"]
    assert 0 < stats["limb"] <= plain["limb"] < 1 << 22
    assert max(stats["ab"], plain["ab"]) < \
        ab_limit * (1 << (16 * B.L)) * B.modulus


def _fresh(J, got):
    """Kernel outputs are re-reduced: exact 16-bit limbs, value < 1.1 p."""
    B = J.F.base if J.is_fp2 else J.F
    w = [1 << (16 * k) for k in range(B.L)]
    for v in got.values():
        flat = (v.movedim(0, 1) if J.is_fp2 else v).reshape(B.L, -1)
        assert int(flat.max()) <= 0xFFFF
        vals = [sum(int(c) * wk for c, wk in zip(col, w))
                for col in flat.T.tolist()]
        assert max(vals) < B.modulus * 11 // 10


def _packed(J, *batches):
    """Canonical packed affine arrays of batches of N lanes (one
    inversion)."""
    every = J.affine_packed({k: torch.cat([X[k] for X in batches], dim=-1)
                             for k in batches[0]})
    return [every[:, i * N:(i + 1) * N] for i in range(len(batches))]


def _jax(P):
    """A port point batch as kzg_tpu's limb arrays."""
    return {k: v.numpy().astype(np.uint32) for k, v in P.items()}


# XLA's CPU compile of kzg_tpu's 25-limb G2 add at its lowest optimization:
# ~6 s against ~9 s (eager, its ~160 small programs take ~12 s); integer
# results, so the same limbs
_XLA_QUICK = {"xla_backend_optimization_level": 0,
              "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def _jax_group(grp, curve):
    """kzg_tpu's G1 or G2 (`grp`) of `curve` and its add, compiled once
    per shape (later adds of the same shapes reuse it)."""
    jJ = (make_g2 if grp == "g2" else make_g1)(jax_curve(curve))
    compiled = {}

    def add(P, Q):
        shape = P["x"].shape
        if shape not in compiled:
            compiled[shape] = jax.jit(jJ.add).lower(P, Q).compile(_XLA_QUICK)
        return compiled[shape](P, Q)

    return jJ, add


def _from_jax(P):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in P.items()}


def _same_limbs(A, B):
    return all(torch.equal(A[k], B[k]) for k in ("x", "y", "z"))


# The BLS12-381 G1 add's widest product: with inputs below 1.1 p the
# products t0..tC are below 1.01 p, the lazy sub(k = 16) adds 247 p
# (lift_limbs(16) on BLS12-381's Fp), so t4, t5 < 248.01 p with exact
# limbs and G = 3b t5 = 12 t5 < 2976.2 p with limbs up to 12 x 65535; its
# product with t4 is a b < 738,120 p^2 < 1.15 R p (R = 2^400 > 645,173 p),
# so that product's output (a b + m p) / R is below 2.15 p, not the 2 p of
# a b < R p (BN254: 1082 p, a b < 0.44 R p). Every other G1 product stays
# below R p; the G1 doubling and G2 keep the BN254 bounds.
BLS_G1_ADD_AB = Fraction(115, 100)

# BN158 (11 limbs, R = 2^176 > 466,000 p): the G1 add's lazy sub(k = 16)
# adds 185 p, but its G = 3b t5 is a product (3b = 39 > 14), so the widest
# product is t3 M, both below ~187 p: a b < 35,000 p^2 < 0.08 R p (measured
# 185.4 p, a b = 0.074 R p). The G1 doubling's sub(k = 32) adds 200 p to a
# fresh value (200.7 p). G2 (qnr = 5): a product's c0 = v0 + 5 v1 is lazy,
# < 6.1 p with limbs up to 6 x 65535, and its exact subtractions add 16 p
# or 32 p; the widest inputs are Karatsuba sums of such values times small
# scales (8 Y^2 in the doubling: measured 65.5 p, past the 64 p contract,
# limbs up to 3,270,656 < 2^22; the add 32.7 p). Every BN158 product is held
# to the plain version's own inputs and to a b < 0.1 R p.
BN158_AB = Fraction(1, 10)

@pytest.mark.parametrize("grp,with_reset,curve,split", [
    pytest.param("g2", False, "BN254", False, id="False"),
    pytest.param("g2", True, "BN254", True, id="True"),
    pytest.param("g1", False, "BN254", False, id="g1-False"),
    pytest.param("g1", True, "BN254", True, id="g1-True"),
    pytest.param("g2", True, "BLS12381", False, id="bls-True"),
    pytest.param("g2", True, "BLS12381", True, id="bls-split-True"),
    pytest.param("g1", True, "BLS12381", True, id="bls-g1-True"),
    pytest.param("g2", True, "BN158", True, id="bn158-True"),
    pytest.param("g1", True, "BN158", True, id="bn158-g1-True")])
def test_add_schedule_matches_plain(grp, with_reset, curve, split,
                                    monkeypatch):
    """On BLS12-381 the G1 add's products are held to a b < 1.15 R p
    (BLS_G1_ADD_AB: the output bound 2.15 p derived above), and the
    widest one must reach past R p, as the derivation says it can; on
    BN254 the G1 add's widest product input must reach its ~1082 p. The
    split executor's block gives the lane executor's limbs and kzg_tpu's
    points, and both executors' product inputs are held to the bounds."""
    J, og, P, Q, pts, qts = _batch(grp, curve)
    reset = torch.tensor([i % 3 == 1 for i in range(N)]) if with_reset \
        else None
    stats = {}
    got = team.plain_add(J, P, Q, reset, stats=stats,
                         blk=team.split_block(J) if split else None)
    want, plain = _plain_once(("add", grp, curve), J,
                              lambda: J._add_plain(P, Q), monkeypatch)
    if reset is not None:
        want = J.select(reset, Q, want)
    extra, runs = (), [stats]
    if split:
        runs.append({})
        assert _same_limbs(got, team.plain_add(J, P, Q, reset,
                                               stats=runs[-1]))
        jJ, add = _jax_group(grp, curve)
        extra = (_from_jax(jJ.select(reset.numpy(), _jax(Q),
                                     add(_jax(P), _jax(Q)))),)
    packed, ref, *jax_ref = _packed(J, got, want, *extra)
    assert torch.equal(packed, ref)
    assert all(torch.equal(packed, r) for r in jax_ref)
    sums = [og.add(a, b) for a, b in zip(pts, qts)]
    if reset is not None:
        sums = [b if s else c for b, s, c in zip(qts, reset.tolist(), sums)]
    assert J.unpack_affine(packed) == sums
    _fresh(J, got)
    for st in runs:
        if curve == "BLS12381" and grp == "g1":
            _check_bounds(grp, J, st, plain, BLS_G1_ADD_AB)
            R = 1 << (16 * J.F.L)
            assert min(plain["ab"], st["ab"]) > R * J.F.modulus
            assert st["value"] > 2900 * J.F.modulus
        else:
            _check_bounds(grp, J, st, plain,
                          BN158_AB if curve == "BN158" else 1)
        if curve == "BN254" and grp == "g1":
            assert st["value"] > 1080 * J.F.modulus


@pytest.mark.parametrize("grp,times,curve,split", [
    pytest.param("g2", 1, "BN254", False, id="1"),
    pytest.param("g2", 3, "BN254", False, id="3"),
    pytest.param("g1", 1, "BN254", False, id="g1-1"),
    pytest.param("g1", 3, "BN254", False, id="g1-3"),
    pytest.param("g2", 3, "BLS12381", False, id="bls-3"),
    pytest.param("g2", 3, "BLS12381", True, id="bls-split-3"),
    pytest.param("g1", 3, "BLS12381", True, id="bls-g1-3"),
    pytest.param("g2", 3, "BN158", True, id="bn158-3"),
    pytest.param("g1", 3, "BN158", True, id="bn158-g1-3")])
def test_dbl_schedule_matches_plain(grp, times, curve, split, monkeypatch):
    """The split executor's block gives the lane executor's limbs and
    kzg_tpu's add of P + P, `times` times; both executors' product inputs
    are held to the bounds."""
    J, og, P, _, pts, _ = _batch(grp, curve)
    stats = {}
    got = team.plain_dbl(J, P, times, stats=stats,
                         blk=team.split_block(J) if split else None)

    def chain():
        R = P
        for _ in range(times):
            R = J._dbl_plain(R)
        return R

    want, plain = _plain_once(("dbl", grp, curve, times), J, chain,
                              monkeypatch)
    extra, runs = (), [stats]
    if split:
        runs.append({})
        assert _same_limbs(got, team.plain_dbl(J, P, times, stats=runs[-1]))
        A = _jax(P)
        for _ in range(times):
            A = _jax_group(grp, curve)[1](A, A)
        extra = (_from_jax(A),)
    packed, ref, *jax_ref = _packed(J, got, want, *extra)
    assert torch.equal(packed, ref)
    assert all(torch.equal(packed, r) for r in jax_ref)
    assert J.unpack_affine(packed) == [og.mul(1 << times, a) for a in pts]
    _fresh(J, got)
    for st in runs:
        _check_bounds(grp, J, st, plain, BN158_AB if curve == "BN158" else 1)


def _fits(w):
    """The table's words fit the kernels' constant image (team.cuh
    TEAM_WORDS = 768, slot ids below 240); the merge kernel (K6) has the
    add's slots."""
    assert team.HDR + w[team.LEVELS] + 3 * w[team.INSTRS] == len(w) <= 768
    assert w[2] < team.CONST0 and w[5] < team.CONST0 and w[8] == w[2]
    assert w[team.WIDE] == team.MERGE_WIDE


def test_table_fits_the_kernel():
    """G2: the product rounds of a team (the lane's serial chain of
    products) are those of the shipped layout: 7 per add (ceil(48 / 8) = 6
    would need every level full), one for a reset lane and for the
    re-reduction, ceil(27 / 8) = 4 per doubling. BN254's split tables (K2
    and K4 below the width rule at 17 limbs) fit too: G1 3 rounds an add
    at 12 products a round and 3 a doubling at 6, G2 5 rounds an add and
    3 a doubling at 16."""
    ctx = get_context("BN254", "cpu")
    J = ctx.g2
    w = team.table(J)
    assert (w[0:2], w[3:5], w[6:8]) == team.LAYOUT["g2"] == (
        (8, 2), (8, 2), (8, 2))
    _fits(w)
    assert team.rounds(w) == [7, 1, 4, 1]
    _split_fits(ctx, 17, ([3, 1, 3, 1], [5, 1, 3, 1]))


def test_g1_table_fits_the_kernel():
    """G1: 3 product rounds per add at 6 threads per team (6 | 6 | 3
    products), 3 per doubling at 3 (3 | 3 | 3), one for a reset lane and
    for the re-reduction; the EXACT slack rows are m p with the multiples
    m that Field.sub(k = 16, 32) lifts by, so the subtractions keep the
    plain values."""
    J = get_context("BN254", "cpu").g1
    F = J.F
    w = team.table(J)
    assert (w[0:2], w[3:5], w[6:8]) == team.LAYOUT["g1"]
    _fits(w)
    assert team.rounds(w) == [3, 1, 3, 1]
    rows = team.rows(J)
    val = [sum(v << (16 * i) for i, v in enumerate(rows[r * F.L:
                                                        (r + 1) * F.L]))
           for r in range(team.ROWS)]
    lifts = [sum(v << (16 * i) for i, v in enumerate(F.lift_limbs(k)[0]))
             for k in (16, 32)]
    assert val[3:6] == [0] + lifts
    assert lifts == [F.lift_limbs(16)[1] * F.modulus,
                     F.lift_limbs(32)[1] * F.modulus]
    assert val[0] == F.params.mont_r % F.modulus
    assert val[1] == 3 * J._b3_int * F.params.mont_r % F.modulus


def _fit_at(curve, L, rounds, lifts):
    """Both groups' tables of `curve` fit the kernels' image with the
    given product rounds (G1, G2), the constant rows are ROWS x L words
    with G1's slacks the lifts' m p, 9b and 3b in Montgomery form in rows
    C1 and C2, and each kernel kind's shared memory per block (team.cuh
    team_prepare: 8 L constant words, then slots x L x lanes per block)
    stays within what one block may hold (232,448 bytes)."""
    ctx = get_context(curve, "cpu")
    F = ctx.fp
    assert F.L == L
    for J, want in zip((ctx.g1, ctx.g2), rounds):
        w = team.table(J)
        _fits(w)
        assert team.rounds(w) == want
        rows = team.rows(J)
        assert len(rows) == team.ROWS * F.L
        for k in range(team.KINDS):
            per, warps, slots = w[3 * k:3 * k + 3]
            smem = 4 * (team.ROWS * F.L + slots * F.L * (32 // per) * warps)
            assert smem <= 232448
    rows = team.rows(ctx.g1)
    val = [sum(v << (16 * i) for i, v in enumerate(rows[r * F.L:
                                                        (r + 1) * F.L]))
           for r in range(team.ROWS)]
    assert [F.lift_limbs(k)[1] for k in (16, 32)] == lifts
    assert val[3:6] == [0] + [m * F.modulus for m in lifts]
    b3 = ctx.g1._b3_int
    assert val[1:3] == [3 * b3 * F.params.mont_r % F.modulus,
                        b3 * F.params.mont_r % F.modulus]
    return ctx


def test_tables_fit_the_kernel_at_25_limbs(monkeypatch):
    """BLS12-381 (Fp of 25 limbs): both groups' tables fit the kernels'
    image with BN254's rounds (the table does not depend on L), with G1's
    slacks the lifts' m p (m = 247 and 266). Each group's split table
    (K2-K5 below the width rule) fits too: the same instructions leveled
    for P = T / R products a round (G2: 5 rounds an add at 16, the least
    its five product levels allow, and 3 a doubling; G1: 3 rounds an add,
    6 | 6 | 3 products at 6 a round, and 3 a doubling, 4 | 3 | 2 at 4),
    the layout and R in its header, the shared memory of split_prepare
    within a block's, and a layout that split_prepare refuses raises here
    (its shared memory: the rows, the padded p, the table's 768 words, the
    slots and each sub-team's operand rows). A group without a split
    layout at its limb count (25 taken out of SPLIT_LAYOUT) raises."""
    ctx = _fit_at("BLS12381", 25, ([3, 1, 3, 1], [7, 1, 4, 1]), [247, 266])
    _split_fits(ctx, 25, ([3, 1, 3, 1], [5, 1, 3, 1]))
    for J, grp in ((ctx.g1, "g1"), (ctx.g2, "g2")):
        monkeypatch.delitem(team.SPLIT_LAYOUT[grp], 25)
        with pytest.raises(ValueError, match="no split-executor layout"):
            team.split_table(J)


def _split_fits(ctx, L, rounds):
    """Both groups' split tables of ctx at L limbs fit, with the product
    rounds `rounds` (G1, G2), the shipped layouts and their R in the
    header, the lane table's instructions, split_prepare's shared memory
    within a block's; refused layouts raise."""
    for J, grp, rounds in ((ctx.g1, "g1", rounds[0]),
                           (ctx.g2, "g2", rounds[1])):
        lane, w = team.table(J), team.split_table(J)
        _fits(w)
        layout = team.SPLIT_LAYOUT[grp][L]
        assert team.split_layout(J) == layout
        assert [tuple(w[3 * k:3 * k + 2]) + (w[team.RANKS + k],)
                for k in range(team.KINDS)] == [layout[0], layout[1],
                                                layout[0]]
        assert [lane[team.RANKS + k] for k in range(team.KINDS)] == [1, 1, 1]
        assert team.rounds(w) == rounds
        assert w[team.INSTRS] == lane[team.INSTRS]
        for k, (per, warps, ranks) in enumerate(layout):
            pz = 3 * L + 31              # team.cuh SPLIT_PZ, SPLIT_ROW
            rows = per // ranks * (L + pz)
            smem = 4 * (team.ROWS * L + pz + 768
                        + (w[3 * k + 2] * L + rows) * 32 * warps // per)
            assert smem <= 232448
        for bad in ((48, 2, 16), (64, 1, 16), (32, 2, 12), (96, 3, 64),
                    (320, 10, 16), (32, 10, 8)):
            with pytest.raises(ValueError, match="split layout"):
                team.split_table(J, (bad, layout[1]))
            with pytest.raises(ValueError, match="split layout"):
                team.split_table(J, (layout[0], bad))


def test_tables_fit_the_kernel_at_11_limbs():
    """BN158 (Fp of 11 limbs) on its own branches: G1's 3b = 39 is a
    product by row C2, so an add has 6 | 2 | 6 products (4 rounds at 6
    threads per team, 14 products against BN254's 12) and a doubling 10
    (4 rounds at 3: zz feeds the products by 3b and by 9b); G2's qnr = 5
    gives a table of its own (the cache key carries qnr) with BN254's
    rounds and more slots; G1's slacks m p with m = 185 and 200. The split
    tables (K2-K5 below the width rule) fit: G1 4 rounds an add at 12
    products a round (6 | 2 | 6, then 3), 3 a doubling; G2 5 rounds an add
    at 32, 3 a doubling at 16."""
    ctx = _fit_at("BN158", 11, ([4, 1, 4, 1], [7, 1, 4, 1]), [185, 200])
    _split_fits(ctx, 11, ([4, 1, 3, 1], [5, 1, 3, 1]))
    bn = get_context("BN254", "cpu")
    assert team.table(ctx.g2) != team.table(bn.g2)
    assert team._key(ctx.g2) == ("g2", 5) and team._key(bn.g2) == ("g2", -1)


def test_kernel_constants_refuse_unencoded_branches():
    """The point kernels' constants (ops/cuda.py _g1_consts, _g2_consts),
    K1's 2 L + 2 modulus words (cuda.mod_words) then the team block (with
    `split`, the split block, on all three curves), are
    built for the branches the schedules encode, G1 with 9b > 15 (3b a
    scale up to 14 or a product) and G2 with qnr = -1 or 5 (all three
    curves), and refused for any other: a G1 with 3b = 3 (9b = 9 lazy in
    the plain doubling) and an Fp2 with qnr = 3."""
    from kzg_tpu_torch.fields.quadratic import Fp2
    from kzg_tpu_torch.groups.ec import Curve
    from kzg_tpu_torch.ops import cuda
    for curve in ("BN254", "BLS12381", "BN158"):
        ctx = get_context(curve, "cpu")
        for J, consts in ((ctx.g1, cuda._g1_consts),
                          (ctx.g2, cuda._g2_consts)):
            B = J.F.base if J.is_fp2 else J.F
            assert consts(J)[:2 * B.L + 2] == cuda.mod_words(B)
            assert consts(J)[2 * B.L + 2:] == team.block(J)
    for curve in ("BN254", "BLS12381", "BN158"):
        ctx = get_context(curve, "cpu")
        n = 2 * ctx.fp.L + 2
        assert cuda._g2_consts(ctx.g2, split=True)[n:] == \
            team.split_block(ctx.g2)
        assert cuda._g1_consts(ctx.g1, split=True)[n:] == \
            team.split_block(ctx.g1)
    ctx = get_context("BN158", "cpu")
    with pytest.raises(ValueError, match="9b > 15"):
        cuda._g1_consts(Curve(ctx.fp, 3, name="b1"))
    with pytest.raises(ValueError, match="qnr"):
        cuda._g2_consts(Curve(Fp2(ctx.fp, 3), (156, 39), name="qnr3"))


class _FakePoint:
    """Stands in for g1_ops or g2_ops (by G's group) at G's limb count:
    records the entry point and the constant block it reads back from the
    raw pointer, and, on launches of at most N lanes, reads the coordinates and
    the reset mask back too and writes the outputs of team.plain_add /
    plain_dbl (the lane executor's model) to `out` (wider launches: the
    routing alone, on the CPU's time). Its kzg_* attributes are the four
    entry points of the group, lane and split."""

    def __init__(self, G):
        self.G, self.calls = G, []
        self.L = G.F.base.L if G.is_fp2 else G.F.L
        self.lead = (2, self.L) if G.is_fp2 else (self.L,)

    def _point(self, ptrs, lanes):
        n = int(np.prod(self.lead)) * lanes
        return {k: torch.from_numpy(np.ctypeslib.as_array(
            (ctypes.c_int64 * n).from_address(p)).reshape(
                self.lead + (lanes,)).copy())
            for k, p in zip(("x", "y", "z"), ptrs)}

    def _block(self, consts):
        words = ctypes.cast(consts, ctypes.POINTER(ctypes.c_uint32))
        head = 2 * self.L + 2 + team.ROWS * self.L
        n = (team.HDR + words[head + team.LEVELS]
             + 3 * words[head + team.INSTRS])
        return words[2 * self.L + 2:head + n]

    def _write(self, ptr, R):
        out = torch.stack([R[k] for k in ("x", "y", "z")]).reshape(-1)
        np.ctypeslib.as_array((ctypes.c_int64 * out.numel()).from_address(
            ptr))[:] = out.numpy()

    def _add(self, entry, px, py, pz, qx, qy, qz, reset, out, lanes, consts,
             n_limbs, stream):
        self.calls.append((entry, n_limbs, self._block(consts)))
        if lanes > N:
            return 0
        mask = None if reset is None else torch.from_numpy(
            np.ctypeslib.as_array((ctypes.c_uint8 * lanes).from_address(
                reset)).astype(bool))
        self._write(out, team.plain_add(
            self.G, self._point((px, py, pz), lanes),
            self._point((qx, qy, qz), lanes), mask))
        return 0

    def _dbl(self, entry, px, py, pz, out, lanes, times, consts, n_limbs,
             stream):
        self.calls.append((entry, n_limbs, self._block(consts)))
        if lanes > N:
            return 0
        self._write(out, team.plain_dbl(
            self.G, self._point((px, py, pz), lanes), times))
        return 0

    def __getattr__(self, entry):
        grp = "g2" if self.G.is_fp2 else "g1"
        for op in ("add", "dbl"):
            if entry in (f"kzg_{grp}_{op}", f"kzg_{grp}_{op}_split"):
                fn = self._add if op == "add" else self._dbl
                return lambda *a: fn(entry, *a)
        raise AttributeError(entry)


def test_g2_wrapper_picks_the_variant_by_width(monkeypatch):
    """For every kernel and limb count of the width rule (K2-K5 on
    BLS12-381's 25 limbs and on BN158's 11, K2 and K4 on BN254's 17), just
    below
    SPLIT_BELOW[name][L] lanes cuda.g1_add / g1_dbl / g2_add / g2_dbl call
    the split entry point with the split block (team.split_block), at that
    width the lane entry point with team.block, `team` True or False forces
    either at one lane, each from its group's library built at L limbs,
    each launch counted once under the kernel's key at L; at one lane the
    outputs are the model's limbs (held to the plain versions above).
    point_grid gives each variant's launch. At 11 limbs K3 and K5 keep
    the lane entry point at the widths above their rule that
    precompute_shifted launches (a setup of 4,097 or 5,000 points). At 17
    limbs K3 and K5 have no rule: they keep the lane entry point at one
    lane, and `team` True reaches their split one. A limb count without a
    split layout (17 taken out of SPLIT_LAYOUT) refuses a forced split in
    either group."""
    monkeypatch.setattr(cuda, "_stream", lambda: None)
    monkeypatch.setattr(cuda, "_require", lambda *a, **k: None)
    curve_at = {25: "BLS12381", 11: "BN158", cuda.BASE_L: "BN254"}
    fakes = {}
    asked = []

    def lib(source, limbs=cuda.BASE_L):
        asked.append((source, limbs))
        grp = source[:2]
        if (grp, limbs) not in fakes:
            fakes[grp, limbs] = _FakePoint(_batch(grp, curve_at[limbs])[0])
        return fakes[grp, limbs]

    monkeypatch.setattr(cuda, "_lib", lib)

    def tiled(X, n):
        return {k: v.repeat(*[1] * (v.ndim - 1), -(-n // N))[..., :n]
                .contiguous() for k, v in X.items()}

    def launch(name, L, lanes, team_arg, split):
        grp = name[:2]
        J, og, P0, Q0, pts, qts = _batch(grp, curve_at[L])
        P, Q = tiled(P0, lanes), tiled(Q0, lanes)
        reset = torch.arange(lanes) % 3 == 1
        before = cuda.counts()
        if name.endswith("_add"):
            got = getattr(cuda, name)(J, P, Q, reset, team=team_arg)
        else:
            got = getattr(cuda, name)(J, P, 1, team=team_arg)
        after = cuda.counts()
        entry = "kzg_" + name + ("_split" if split else "")
        block = team.split_block(J) if split else team.block(J)
        assert fakes[grp, L].calls[-1] == (entry, L, block)
        assert asked[-1] == (f"{grp}_ops", L)
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {cuda.kernel_key(name, L): 1}
        if lanes <= N:
            assert _same_limbs(got, team.plain_add(J, P, Q, reset)
                               if name.endswith("_add") else
                               team.plain_dbl(J, P, 1))

    assert sorted(cuda.SPLIT_BELOW) == ["g1_add", "g1_dbl", "g2_add",
                                        "g2_dbl"]
    assert sorted((n, L) for n, b in cuda.SPLIT_BELOW.items() for L in b) \
        == [("g1_add", 11), ("g1_add", 17), ("g1_add", 25), ("g1_dbl", 11),
            ("g1_dbl", 25), ("g2_add", 11), ("g2_add", 17), ("g2_add", 25),
            ("g2_dbl", 11), ("g2_dbl", 25)]
    for name, below in cuda.SPLIT_BELOW.items():
        grp, kind = name[:2], name.endswith("_dbl")
        for L, rule in below.items():
            for lanes, team_arg, split in ((rule - 1, None, True),
                                           (rule, None, False),
                                           (1, False, False), (1, True, True)):
                launch(name, L, lanes, team_arg, split)
            per, warps, _ = team.SPLIT_LAYOUT[grp][L][kind]
            assert cuda.point_grid(name, L, rule - 1) == (
                -(-(rule - 1) * per // (32 * warps)), 32 * warps)
            lane = team.LAYOUT[grp][kind]
            assert cuda.point_grid(name, L, rule) == (
                -(-rule // (32 // lane[0] * lane[1])), 32 * lane[1])
    for grp in ("g1", "g2"):
        for lanes in (4097, 5000):
            assert lanes >= cuda.SPLIT_BELOW[f"{grp}_dbl"][11]
            launch(f"{grp}_dbl", 11, lanes, None, False)
        launch(f"{grp}_dbl", cuda.BASE_L, 1, None, False)
        launch(f"{grp}_dbl", cuda.BASE_L, 1, True, True)
    bn = get_context("BN254", "cpu")
    for J, fn, grp in ((bn.g1, cuda.g1_add, "g1"), (bn.g2, cuda.g2_add,
                                                     "g2")):
        monkeypatch.delitem(team.SPLIT_LAYOUT[grp], cuda.BASE_L)
        # the split constants are built at a group's first split launch:
        # drop the ones the launches above left on this group
        monkeypatch.setattr(J, "_kernel_split_consts", None)
        one = J.encode_points([None])
        with pytest.raises(ValueError, match="no split-executor layout"):
            fn(J, one, one, team=True)
