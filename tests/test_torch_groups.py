"""The port's group law (kzg_tpu_torch.groups.ec) against the JAX package's
(kzg_tpu.groups.ec) on the same numpy limb arrays.

On the CPU, add/add_f/dbl_f run the plain versions (Curve._add_plain,
Curve._dbl_plain) that kernels K2 and K3 (G1) and K4 and K5 (G2) are held
against on the card, and the merge strategy's combine runs
MSMEngine._combine_plain, the plain version of K6. The JAX functions run
eagerly (a jit of the G2 doubling chain compiles for tens of seconds on the
CPU); kzg_tpu's add of the first batches is computed once per group and
shared by the add and the combine tests. Both results are compared,
exactly, as canonical packed affine arrays (the port's
Curve.affine_packed); the batches mix random points under a random
projective rescaling with infinity, P + P and P + (-P) lanes.
"""

import functools

import numpy as np
import pytest
import torch

from kzg_tpu.context import make_g1, make_g2
from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.ops.msm import MSMEngine
from kzg_tpu_torch.refmodel.model import G1, G2

torch.set_num_threads(2)

SEED = 20261017
N = 12


@functools.lru_cache(maxsize=None)
def _batches(group, seed):
    """Two point batches (numpy limb arrays, shared by both packages) with
    infinity, doubling and negation lanes, and their oracle points."""
    ctx = get_context("BN254", "cpu")
    cp = ctx.cp
    og = G1(cp) if group == "g1" else G2(cp)
    J = ctx.g1 if group == "g1" else ctx.g2
    rng = np.random.default_rng(seed)

    def rnd(m):
        return int.from_bytes(rng.bytes(40), "little") % m

    pts = [og.mul(rnd(cp.r - 1) + 1, og.gen) for _ in range(N)]
    qts = [og.mul(rnd(cp.r - 1) + 1, og.gen) for _ in range(N)]
    qts[0] = pts[0]                                  # P + P
    qts[1] = og.neg(pts[1])                          # P + (-P)
    pts[2] = None                                    # inf + Q
    qts[3] = None                                    # P + inf
    pts[4] = qts[4] = None                           # inf + inf
    qts[5] = pts[5] = og.gen

    def rescaled(pp):
        P = J.encode_points(pp)
        lam = ctx.fp.encode([rnd(cp.p - 1) + 1 for _ in range(N)])
        if group == "g2":
            lam = torch.stack([lam, torch.zeros_like(lam)], dim=0)
            lam = J.F.mul(lam, J.F.encode([(rnd(cp.p), rnd(cp.p))
                                           for _ in range(N)]))
        return {k: J.F.mul(v, lam).numpy() for k, v in P.items()}

    return ctx, J, og, rescaled(pts), rescaled(qts), pts, qts


def _torch(P):
    return {k: torch.from_numpy(v) for k, v in P.items()}


def _jax(P):
    return {k: v.astype(np.uint32) for k, v in P.items()}


@functools.lru_cache(maxsize=None)
def _jax_add(group):
    """kzg_tpu's add of the SEED batches (numpy limb arrays)."""
    ctx, J, og, P, Q, pts, qts = _batches(group, SEED)
    jJ = make_g1(ctx.cp) if group == "g1" else make_g2(ctx.cp)
    return {k: np.asarray(v) for k, v in jJ.add(_jax(P), _jax(Q)).items()}


def _packed(J, P):
    """Canonical packed affine array of a torch or a JAX point batch, by the
    port's Curve.affine_packed (exact: to_affine, from_mont, canon)."""
    P = {k: v if isinstance(v, torch.Tensor)
         else torch.from_numpy(np.asarray(v).astype(np.int64))
         for k, v in P.items()}
    return J.affine_packed(P).numpy()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_matches_jax(group):
    ctx, J, og, P, Q, pts, qts = _batches(group, SEED)
    got = _packed(J, J.add(_torch(P), _torch(Q)))
    assert np.array_equal(got, _packed(J, _jax_add(group)))
    assert J.unpack_affine(got) == [og.add(a, b) for a, b in zip(pts, qts)]
    # add_f is the same operation (one K2 launch for G1 on the card)
    assert np.array_equal(_packed(J, J.add_f(_torch(P), _torch(Q))), got)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_reset_mask_add_matches_jax(group):
    """add(P, Q, reset): lanes with reset set return Q, the others P + Q —
    the chunked bucket scan's step select(s, p, add(c, p))."""
    ctx, J, og, P, Q, pts, qts = _batches(group, SEED + 1)
    jJ = make_g1(ctx.cp) if group == "g1" else make_g2(ctx.cp)
    reset = np.arange(N) % 3 == 1
    got = _packed(J, J.add(_torch(P), _torch(Q),
                           reset=torch.from_numpy(reset)))
    ref = jJ.select(reset, _jax(Q), jJ.add(_jax(P), _jax(Q)))
    assert np.array_equal(got, _packed(J, ref))
    assert J.unpack_affine(got) == [b if s else og.add(a, b)
                                    for a, b, s in zip(pts, qts, reset)]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("times", [1, 8])
def test_dbl_chain_matches_jax(group, times):
    """dbl_f(times) — `times` chained doublings, one K3 launch for G1 on
    the card — equals kzg_tpu's chained Curve.dbl; dbl equals dbl_f(1)."""
    ctx, J, og, P, _, pts, _ = _batches(group, SEED + 2)
    jJ = make_g1(ctx.cp) if group == "g1" else make_g2(ctx.cp)

    def chain(A):
        for _ in range(times):
            A = jJ.dbl(A)
        return A

    got = _packed(J, J.dbl_f(_torch(P), times))
    assert np.array_equal(got, _packed(J, chain(_jax(P))))
    assert J.unpack_affine(got) == [og.mul(1 << times, a) for a in pts]
    if times == 1:
        assert np.array_equal(_packed(J, J.dbl(_torch(P))), got)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_merge_combine_plain_matches_jax(group):
    """MSMEngine._combine_plain (the plain version of K6) against the merge
    combine of kzg_tpu/ops/msm.py:187-191 built from kzg_tpu's add and
    select on the same arrays: mid = aR + bL, newL = select(asing & fuse,
    mid, aL), newR = select(bsing & fuse, mid, bR); every mask pattern."""
    ctx, J, og, P, Q, pts, qts = _batches(group, SEED)
    _, _, _, A, B, _, _ = _batches(group, SEED + 1)          # aL, bR
    jJ = make_g1(ctx.cp) if group == "g1" else make_g2(ctx.cp)
    lanes = np.arange(N)
    fuse, asing, bsing = lanes % 2 == 0, lanes % 4 < 2, lanes % 8 < 4
    eng = MSMEngine(J, ctx.fr, ctx.cp.r, strategy="merge")
    got = eng._combine(_torch(A), _torch(P), _torch(Q), _torch(B),
                       *[torch.from_numpy(m) for m in (fuse, asing, bsing)])
    mid = _jax_add(group)                                    # aR + bL
    want = (mid, jJ.select(asing & fuse, mid, _jax(A)),
            jJ.select(bsing & fuse, mid, _jax(B)))

    def joined(pts):          # the three outputs as one batch (one inverse)
        return {k: np.concatenate([np.asarray(p[k]).astype(np.int64)
                                   for p in pts], axis=-1) for k in pts[0]}

    assert np.array_equal(_packed(J, joined(got)), _packed(J, joined(want)))


def test_neg_eq_and_affine_roundtrip():
    ctx, J, og, P, Q, pts, qts = _batches("g1", SEED + 3)
    Pt, Qt = _torch(P), _torch(Q)
    assert J.decode_points(Pt) == pts
    assert J.decode_points(J.neg(Pt)) == [og.neg(a) for a in pts]
    assert J.eq(Pt, Qt).tolist() == [a == b for a, b in zip(pts, qts)]
    back = J.encode_points(J.decode_points(Pt))
    assert J.eq(back, Pt).all()
