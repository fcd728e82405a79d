"""The port's MSM (kzg_tpu_torch.ops.msm, the chunked strategy) against the
JAX package's (kzg_tpu.ops.msm) and the exact python oracle.

On the CPU the G1 adds and doubling chains run the plain versions that
kernels K2 and K3 are held against on the card. Scalars include a zero and a
run of equal scalars, so that every window has digit runs longer than a
chunk and the boundary-carry scan and its correction are exercised; the port
also runs with other chunk lengths, which must not change the result.
Points are compared exactly, as canonical packed affine arrays.
"""

import jax
import numpy as np
import pytest
import torch

from kzg_tpu.context import get_context as jax_context
from kzg_tpu.ops.msm import MSMEngine as JMSMEngine
from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.fields.mont import ints_to_limbs
from kzg_tpu_torch.ops.msm import MSMEngine
from kzg_tpu_torch.refmodel.model import G1, G2

torch.set_num_threads(2)

SEED = 20261018


def _inputs(n, group="g1"):
    ctx = get_context("BN254", "cpu")
    cp = ctx.cp
    og = G1(cp) if group == "g1" else G2(cp)
    rng = np.random.default_rng(SEED + n)
    pts, acc = [], og.mul(int(rng.integers(2, 1 << 30)), og.gen)
    for _ in range(n):
        pts.append(acc)
        acc = og.add(acc, og.gen)
    scalars = [int.from_bytes(rng.bytes(40), "little") % cp.r
               for _ in range(n)]
    scalars[0] = 0                               # every digit discarded
    if n > 8:
        rep = scalars[1]
        for i in range(2, 8):
            scalars[i] = rep                     # runs of 7 equal digits
        scalars[8] = rep & ((1 << 64) - 1)       # shares only the low bytes
    exp = None
    for k, P in zip(scalars, pts):
        t = og.mul(k, P)
        if t is not None:
            exp = t if exp is None else og.add(exp, t)
    return ctx, pts, scalars, exp


@pytest.fixture(scope="module")
def jax_msm():
    """kzg_tpu's precompute_shifted + msm_shifted (its default, chunked
    strategy) on the 16-point inputs."""
    n = 16
    ctx, pts, scalars, exp = _inputs(n)
    jctx = jax_context("BN254")
    eng = JMSMEngine(jctx.g1, jctx.fr, ctx.cp.r)
    P = jctx.g1.encode_points(pts)
    sh = jax.jit(eng.precompute_shifted)(P)
    sraw = ints_to_limbs(scalars, ctx.fr.L)
    out = jax.jit(eng.msm_shifted)(sraw, sh)
    return n, {k: np.asarray(v) for k, v in P.items()}, \
        {k: np.asarray(v) for k, v in sh.items()}, \
        {k: np.asarray(v) for k, v in out.items()}


def _t(P):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in P.items()}


@pytest.mark.parametrize("chunk_len", [None, 2, 8])
def test_msm_shifted_matches_jax(jax_msm, chunk_len):
    n, Pj, shj, outj = jax_msm
    ctx, pts, scalars, exp = _inputs(n)
    J = ctx.g1
    eng = MSMEngine(J, ctx.fr, ctx.cp.r)
    eng.chunk_len = chunk_len
    P = _t(Pj)                                   # the same limb arrays
    sh = eng.precompute_shifted(P)
    assert sh["x"].shape == (ctx.fp.L, eng.W, n)
    assert np.array_equal(J.affine_packed(sh).numpy(),
                          J.affine_packed(_t(shj)).numpy())
    sraw = ctx.fr.raw(scalars)
    out = eng.msm_shifted(sraw, sh)
    got = J.affine_packed(out).numpy()
    assert np.array_equal(got, J.affine_packed(_t(outj)).numpy())
    assert J.unpack_affine(got[:, None]) == [exp]


def test_msm_shifted_padded_vs_oracle():
    """n = 9 pads the last chunk with discard-digit infinity points."""
    ctx, pts, scalars, exp = _inputs(9)
    eng = MSMEngine(ctx.g1, ctx.fr, ctx.cp.r)
    sh = eng.precompute_shifted(ctx.g1.encode_points(pts))
    out = eng.msm_shifted(ctx.fr.raw(scalars), sh)
    assert ctx.g1.decode_points({k: v[..., None] for k, v in out.items()}) \
        == [exp]


def test_digits_and_bucket_sums():
    """digits() splits canonical scalars into little-endian bytes, and the
    bucket sums equal the oracle's per-window sums of points by digit."""
    ctx, pts, scalars, _ = _inputs(16)
    J = ctx.g1
    og = G1(ctx.cp)
    eng = MSMEngine(J, ctx.fr, ctx.cp.r)
    eng.chunk_len = 4
    d = eng.digits(ctx.fr.raw(scalars))
    assert d.shape == (eng.W, 16)
    assert [[(s >> (8 * w)) & 0xFF for s in scalars]
            for w in range(eng.W)] == d.tolist()
    W = 2                                        # two windows suffice
    P = J.encode_points(pts)
    Pw = {k: v[..., None, :].expand(v.shape[:-1] + (W, 16))
          for k, v in P.items()}
    buckets = eng._bucket_sums(d[:W], Pw)
    got = J.unpack_affine(J.affine_packed(buckets).numpy())
    exp = []
    for w in range(W):
        for digit in range(1, 256):
            acc = None
            for s, pt in zip(scalars, pts):
                if (s >> (8 * w)) & 0xFF == digit:
                    acc = og.add(acc, pt)
            exp.append(acc)
    assert got == exp


def test_g2_msm_shifted_vs_oracle():
    """The G2 MSM of verify (Z(s) G2 over k + 1 setup points)."""
    ctx, pts, scalars, exp = _inputs(3, "g2")
    eng = ctx.msm_g2
    sh = eng.precompute_shifted(ctx.g2.encode_points(pts))
    out = eng.msm_shifted(ctx.fr.raw(scalars), sh)
    assert ctx.g2.decode_points({k: v[..., None] for k, v in out.items()}) \
        == [exp]
