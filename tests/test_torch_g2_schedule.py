"""The lane-team schedules of kernels K4 (G2 add) and K5 (G2 doubling
chain), kzg_tpu_torch.ops.g2_team, run on the CPU.

The kernels execute the encoded table that g2_team.table() builds;
g2_team.run executes the same words with the base field's plain ops. Here
that interpreter, on a few seeded G2 points (numpy seed) under a random
projective rescaling with doubling, negation and infinity lanes, must give
the points of Curve._add_plain / Curve._dbl_plain (equal as canonical
affine arrays) and of the python-int oracle, and no Montgomery product may
see an input outside the mul contract (value < 64 p, limbs < 2^22). No JAX
call: test_torch_groups.py ties the plain versions to kzg_tpu.
"""

import functools

import numpy as np
import pytest
import torch

from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.ops import g2_team
from kzg_tpu_torch.refmodel.model import G2

torch.set_num_threads(2)

SEED = 20261018
N = 6


@functools.lru_cache(maxsize=None)
def _batch():
    ctx = get_context("BN254", "cpu")
    J, og = ctx.g2, G2(ctx.cp)
    rng = np.random.default_rng(SEED)
    pts = [og.mul(int(k), og.gen) for k in rng.integers(1, 1 << 20, N)]
    qts = [og.mul(int(k), og.gen) for k in rng.integers(1, 1 << 20, N)]
    qts[0] = pts[0]                                  # P + P
    qts[1] = og.neg(pts[1])                          # P + (-P)
    pts[2] = None                                    # inf + Q
    qts[3] = None                                    # P + inf
    pts[4] = qts[4] = None                           # inf + inf

    def rescaled(pp):
        P = J.encode_points(pp)
        p = ctx.cp.p
        lam = J.F.encode([(int.from_bytes(rng.bytes(40), "little") % p,
                           int.from_bytes(rng.bytes(40), "little") % p or 1)
                          for _ in range(N)])
        return {k: J.F.mul(v, lam) for k, v in P.items()}

    return J, og, rescaled(pts), rescaled(qts), pts, qts


def _check_contract(stats, p_ratio=64, limb=1 << 22):
    assert 0 < stats["value_over_p"] < p_ratio
    assert 0 < stats["limb"] < limb


def _packed_pair(J, A, B):
    """Canonical packed affine arrays of two batches (one inversion)."""
    both = J.affine_packed({k: torch.cat([A[k], B[k]], dim=-1) for k in A})
    return both[:, :N], both[:, N:]


@pytest.mark.parametrize("with_reset", [False, True])
def test_add_schedule_matches_plain(with_reset):
    J, og, P, Q, pts, qts = _batch()
    reset = torch.tensor([i % 3 == 1 for i in range(N)]) if with_reset \
        else None
    stats = {}
    got = g2_team.plain_add(J, P, Q, reset, stats=stats)
    want = J._add_plain(P, Q)
    if reset is not None:
        want = J.select(reset, Q, want)
    packed, ref = _packed_pair(J, got, want)
    assert torch.equal(packed, ref)
    sums = [og.add(a, b) for a, b in zip(pts, qts)]
    if reset is not None:
        sums = [b if s else c for b, s, c in zip(qts, reset.tolist(), sums)]
    assert J.unpack_affine(packed) == sums
    assert all(int(v.max()) <= 0xFFFF for v in got.values())   # re-reduced
    _check_contract(stats)


@pytest.mark.parametrize("times", [1, 3])
def test_dbl_schedule_matches_plain(times):
    J, og, P, _, pts, _ = _batch()
    stats = {}
    got = g2_team.plain_dbl(J, P, times, stats=stats)
    want = P
    for _ in range(times):
        want = J._dbl_plain(want)
    packed, ref = _packed_pair(J, got, want)
    assert torch.equal(packed, ref)
    assert J.unpack_affine(packed) == [og.mul(1 << times, a) for a in pts]
    assert all(int(v.max()) <= 0xFFFF for v in got.values())
    _check_contract(stats)


def test_table_fits_the_kernel():
    """The table's words fit the kernel's constant image (g2_team.cuh
    TEAM_WORDS = 768, slot ids below 240), and the product rounds of a team
    (the lane's serial chain of products) are those of the shipped layout:
    7 per add (ceil(48 / 8) = 6 would need every level full), one for a
    reset lane and for the re-reduction, ceil(27 / 8) = 4 per doubling."""
    w = g2_team.table()
    assert w[0] == g2_team.TEAM == 8 and w[1] == g2_team.WARPS
    assert g2_team.HDR + w[3] + 3 * w[4] == len(w) <= 768
    assert w[2] < g2_team.CONST0
    assert g2_team.rounds(w) == [7, 1, 4, 1]
