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
below R p (output < 2 p). No JAX call: test_torch_groups.py ties the plain
versions to kzg_tpu.
"""

import functools

import numpy as np
import pytest
import torch

from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.ops import team
from kzg_tpu_torch.refmodel.model import G1, G2

torch.set_num_threads(2)

SEED = 20261018
N = 6


@functools.lru_cache(maxsize=None)
def _batch(grp):
    ctx = get_context("BN254", "cpu")
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
        return int.from_bytes(rng.bytes(40), "little") % p

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
    """Run the plain version fn(); for G1, record the bounds of every input
    that it gives the base field's product (team.bound_stats)."""
    if J.is_fp2:
        return fn(), None
    F = J.F
    stats = {}
    mul = F._mul_plain

    def recording(a, b):
        team.bound_stats(stats, a, b, F)
        return mul(a, b)

    with monkeypatch.context() as m:
        m.setattr(F, "_mul_plain", recording)
        out = fn()
    return out, stats


def _check_bounds(grp, J, stats, plain):
    """G2: the mul contract. G1: no product input above the plain
    version's own, in value or limbs, and a b < R p for every product."""
    B = J.F.base if J.is_fp2 else J.F
    if grp == "g2":
        _check_contract(stats, B.modulus)
        return
    assert 0 < stats["value"] <= plain["value"]
    assert 0 < stats["limb"] <= plain["limb"] < 1 << 22
    assert max(stats["ab"], plain["ab"]) < (1 << (16 * B.L)) * B.modulus


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


def _packed_pair(J, A, B):
    """Canonical packed affine arrays of two batches (one inversion)."""
    both = J.affine_packed({k: torch.cat([A[k], B[k]], dim=-1) for k in A})
    return both[:, :N], both[:, N:]


@pytest.mark.parametrize("grp,with_reset", [
    pytest.param("g2", False, id="False"), pytest.param("g2", True, id="True"),
    pytest.param("g1", False, id="g1-False"),
    pytest.param("g1", True, id="g1-True")])
def test_add_schedule_matches_plain(grp, with_reset, monkeypatch):
    J, og, P, Q, pts, qts = _batch(grp)
    reset = torch.tensor([i % 3 == 1 for i in range(N)]) if with_reset \
        else None
    stats = {}
    got = team.plain_add(J, P, Q, reset, stats=stats)
    want, plain = _plain_stats(J, lambda: J._add_plain(P, Q), monkeypatch)
    if reset is not None:
        want = J.select(reset, Q, want)
    packed, ref = _packed_pair(J, got, want)
    assert torch.equal(packed, ref)
    sums = [og.add(a, b) for a, b in zip(pts, qts)]
    if reset is not None:
        sums = [b if s else c for b, s, c in zip(qts, reset.tolist(), sums)]
    assert J.unpack_affine(packed) == sums
    _fresh(J, got)
    _check_bounds(grp, J, stats, plain)


@pytest.mark.parametrize("grp,times", [
    pytest.param("g2", 1, id="1"), pytest.param("g2", 3, id="3"),
    pytest.param("g1", 1, id="g1-1"), pytest.param("g1", 3, id="g1-3")])
def test_dbl_schedule_matches_plain(grp, times, monkeypatch):
    J, og, P, _, pts, _ = _batch(grp)
    stats = {}
    got = team.plain_dbl(J, P, times, stats=stats)

    def chain():
        R = P
        for _ in range(times):
            R = J._dbl_plain(R)
        return R

    want, plain = _plain_stats(J, chain, monkeypatch)
    packed, ref = _packed_pair(J, got, want)
    assert torch.equal(packed, ref)
    assert J.unpack_affine(packed) == [og.mul(1 << times, a) for a in pts]
    _fresh(J, got)
    _check_bounds(grp, J, stats, plain)


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
    re-reduction, ceil(27 / 8) = 4 per doubling."""
    J = get_context("BN254", "cpu").g2
    w = team.table(J)
    assert (w[0:2], w[3:5], w[6:8]) == team.LAYOUT["g2"] == (
        (8, 2), (8, 2), (8, 2))
    _fits(w)
    assert team.rounds(w) == [7, 1, 4, 1]


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
