"""The port's MSM (kzg_tpu_torch.ops.msm: the chunked strategy of
msm_shifted, the merge, log and scan strategies and msm over arbitrary
bases) against the JAX package's (kzg_tpu.ops.msm) and the exact python
oracle.

On the CPU the G1/G2 adds, doubling chains and merge combines run the plain
versions that kernels K2-K6 are held against on the card. Scalars include a
zero and a run of equal scalars, so that every window has digit runs longer
than a chunk and the boundary-carry scan and its correction are exercised;
the port also runs with other chunk lengths, which must not change the
result. Points are compared exactly, as canonical packed affine arrays. The
JAX functions run under jax.jit and only the pieces compared (never the
whole JAX msm, whose jit takes tens of seconds on the CPU).
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


def _t(P):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in P.items()}


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
    """The port's precompute_shifted of the 16-point inputs (computed once
    for every chunk length) and kzg_tpu's msm_shifted (its default, chunked
    strategy) of the same window-shifted limb arrays."""
    n = 16
    ctx, pts, scalars, exp = _inputs(n)
    sh = MSMEngine(ctx.g1, ctx.fr, ctx.cp.r).precompute_shifted(
        ctx.g1.encode_points(pts))
    jctx = jax_context("BN254")
    eng = JMSMEngine(jctx.g1, jctx.fr, ctx.cp.r)
    sraw = ints_to_limbs(scalars, ctx.fr.L)
    out = jax.jit(eng.msm_shifted)(
        sraw, {k: v.numpy().astype(np.uint32) for k, v in sh.items()})
    return n, sh, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("chunk_len", [None, 2, 8])
def test_msm_shifted_matches_jax(jax_msm, chunk_len):
    n, sh, outj = jax_msm
    ctx, pts, scalars, exp = _inputs(n)
    J = ctx.g1
    og = G1(ctx.cp)
    eng = MSMEngine(J, ctx.fr, ctx.cp.r)
    eng.chunk_len = chunk_len
    assert sh["x"].shape == (ctx.fp.L, eng.W, n)
    if chunk_len is None:     # every window-shifted base 2^(8w) P_i
        rows, row = [], list(pts)
        for _ in range(eng.W):
            rows.append(row)
            for _ in range(8):
                row = [og.add(P, P) for P in row]
        assert J.decode_points({k: v.reshape(v.shape[:-2] + (-1,))
                                for k, v in sh.items()}) == sum(rows, [])
    sraw = ctx.fr.raw(scalars)
    out = eng.msm_shifted(sraw, sh)
    got = J.affine_packed(out).numpy()
    assert np.array_equal(got, J.affine_packed(_t(outj)).numpy())
    assert J.unpack_affine(got[:, None]) == [exp]


@pytest.fixture(scope="module")
def chunked_11():
    """The 11-point G1 inputs and the port's chunked msm_shifted of them."""
    ctx, pts, scalars, exp = _inputs(11)
    J = ctx.g1
    eng = MSMEngine(J, ctx.fr, ctx.cp.r)
    P = J.encode_points(pts)
    out = eng.msm_shifted(ctx.fr.raw(scalars), eng.precompute_shifted(P))
    return ctx, P, scalars, exp, \
        J.affine_packed({k: v[..., None] for k, v in out.items()}).numpy()


def test_msm_shifted_padded_vs_oracle(chunked_11):
    """n = 11 (chunks of 4) pads the last chunk with a discard-digit
    infinity point."""
    ctx, P, scalars, exp, chunked = chunked_11
    assert ctx.g1.unpack_affine(chunked) == [exp]


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


def test_bucket_sums_merge_matches_jax():
    """The port's merge-strategy bucket sums (its per-level combine is
    MSMEngine._combine_plain, the plain version of K6, on the CPU) against
    kzg_tpu's MSMEngine(strategy='merge')._bucket_sums_merge under jax.jit,
    on the same sorted numpy limb arrays: two windows of the 11-point inputs
    (a zero scalar, a run of 7 equal digits), which both pad to 16; and
    against the oracle's per-window sums of points by digit."""
    n, W = 11, 2
    ctx, pts, scalars, _ = _inputs(n)
    J = ctx.g1
    og = G1(ctx.cp)
    eng = MSMEngine(J, ctx.fr, ctx.cp.r, strategy="merge")
    d = eng.digits(ctx.fr.raw(scalars))[:W].numpy()
    order = np.argsort(d, axis=-1, kind="stable")
    d_sorted = np.take_along_axis(d, order, axis=-1)
    P_sorted = {k: v.numpy()[:, order]                   # (L, W, n)
                for k, v in J.encode_points(pts).items()}
    jctx = jax_context("BN254")
    jeng = JMSMEngine(jctx.g1, jctx.fr, ctx.cp.r, strategy="merge")
    want = jax.jit(jeng._bucket_sums_merge)(
        d_sorted.astype(np.uint32),
        {k: v.astype(np.uint32) for k, v in P_sorted.items()})
    got = eng._bucket_sums_merge(torch.from_numpy(d_sorted), _t(P_sorted))
    assert got["x"].shape == (ctx.fp.L, W, 255)
    got = J.affine_packed(got).numpy()
    assert np.array_equal(got, J.affine_packed(_t(want)).numpy())
    exp = []
    for w in range(W):
        for digit in range(1, 256):
            acc = None
            for s, pt in zip(scalars, pts):
                if (s >> (8 * w)) & 0xFF == digit:
                    acc = og.add(acc, pt)
            exp.append(acc)
    assert J.unpack_affine(got) == exp


@pytest.mark.parametrize("strategy", ["merge", "log", "scan"])
def test_msm_strategies_vs_oracle_and_chunked(chunked_11, strategy):
    """msm over arbitrary bases (Horner over the windows) with each of the
    other bucket strategies equals the oracle and the chunked msm_shifted."""
    ctx, P, scalars, exp, chunked = chunked_11
    J = ctx.g1
    eng = MSMEngine(J, ctx.fr, ctx.cp.r, strategy=strategy)
    out = eng.msm(ctx.fr.raw(scalars), P)
    got = J.affine_packed({k: v[..., None] for k, v in out.items()}).numpy()
    assert np.array_equal(got, chunked)
    assert J.unpack_affine(got) == [exp]
    with pytest.raises(ValueError):
        MSMEngine(J, ctx.fr, ctx.cp.r, strategy="naive")


def test_g2_msm_merge_vs_oracle():
    """G2 msm over arbitrary bases with the merge strategy, over two
    windows: 16-bit scalars and an engine whose order spans 16 bits (the
    window count follows the order; chip_smoke.py runs all 32 windows on
    the card)."""
    ctx, pts, scalars, _ = _inputs(3, "g2")
    og = G2(ctx.cp)
    scalars = [s & 0xFFFF for s in scalars]
    scalars[1] = scalars[2] & 0xFF00 | 0x17   # a shared high digit
    exp = None
    for k, P in zip(scalars, pts):
        t = og.mul(k, P)
        if t is not None:
            exp = t if exp is None else og.add(exp, t)
    eng = MSMEngine(ctx.g2, ctx.fr, (1 << 16) - 1, strategy="merge")
    assert eng.W == 2
    out = eng.msm(ctx.fr.raw(scalars), ctx.g2.encode_points(pts))
    assert ctx.g2.decode_points({k: v[..., None] for k, v in out.items()}) \
        == [exp]
