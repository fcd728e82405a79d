"""The port's field arithmetic (kzg_tpu_torch.fields) against the JAX
package's (kzg_tpu.fields) on the same numpy limb arrays.

The port runs on the CPU here, so Field.mul runs its plain version
(Field._mul_plain), the int64 schoolbook product plus word-by-word Montgomery
reduction that kernel K1 is held against on the card. All arithmetic is
integer, so the tolerance is exact equality of canonical values
canon(from_mont(.)); raw lazy limbs are never compared, because the two
packages may represent one value by different lazy limbs.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from kzg_tpu.curves.params import get_curve as jax_curve
from kzg_tpu.fields.mont import Field as JField
from kzg_tpu.fields.quadratic import Fp2 as JFp2
from kzg_tpu_torch.curves.params import get_curve
from kzg_tpu_torch.fields.mont import Field, ints_to_limbs, limbs_to_ints
from kzg_tpu_torch.fields.quadratic import Fp2
from kzg_tpu_torch.ops import cuda
from kzg_tpu_torch.refmodel.model import Tower

torch.set_num_threads(2)

SEED = 20261016
N = 24


@functools.lru_cache(maxsize=None)
def _fields(which):
    """The port's and kzg_tpu's field, and kzg_tpu's jitted functions (one
    jit per function, so that each compiles once per shape)."""
    cp, jcp = get_curve("BN254"), jax_curve("BN254")
    fp = cp.fp if which == "fp" else cp.fr
    jfp = jcp.fp if which == "fp" else jcp.fr
    jF = JField(jfp)
    jit = {"canon": jax.jit(lambda a: jF.canon(jF.from_mont(a))),
           "mul": jax.jit(jF.mul), "add": jax.jit(jF.add),
           "inv": jax.jit(jF.inv), "batch_inv": jax.jit(jF.batch_inv),
           "raw_canon": jax.jit(jF.canon)}
    for lazy in (True, False):
        jit[("sub", lazy)] = jax.jit(
            lambda x, y, lazy=lazy: jF.sub(x, y, k=16, lazy=lazy))
    return Field(fp, "cpu"), jF, jit


def _lazy_limbs(p, L, n, rng, top):
    """(L, n) int64 limbs of values below `top` * p whose limbs reach up to
    2^22 - 1: random canonical values, then up to 63 * 2^16 borrowed from
    each limb into the one below it (the value is unchanged). Lanes 0-3 hold
    0, p, p - 1 and top * p - 1."""
    vals = [int.from_bytes(rng.bytes(40), "little") % (top * p)
            for _ in range(n)]
    vals[:4] = [0, p, p - 1, top * p - 1]
    x = ints_to_limbs(vals, L).astype(np.int64)
    for i in range(L - 1):
        t = np.minimum(rng.integers(0, 64, n), x[i + 1])
        x[i] += t << 16
        x[i + 1] -= t
    return x, vals


def _canon_t(F, x):
    return F.canon(F.from_mont(x)).numpy()


def _canon_j(jit, x):
    return np.asarray(jit["canon"](x))


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_mul_matches_jax_at_lazy_edges(which):
    """mul on inputs at the lazy contract's edges (value < 64 p, limbs up
    to 2^22 - 1) equals kzg_tpu's, equals a*b*R^-1 mod p, and returns
    exact 16-bit limbs with value < 1.1 p. mul_many equals the single muls."""
    F, _, jit = _fields(which)
    p, L = F.modulus, F.L
    rng = np.random.default_rng(SEED)
    a, av = _lazy_limbs(p, L, N, rng, 64)
    b, bv = _lazy_limbs(p, L, N, rng, 64)
    assert a.max() >= (1 << 21) and a.max() < (1 << 22)
    out = F.mul(torch.from_numpy(a), torch.from_numpy(b))
    jout = jit["mul"](a.astype(np.uint32), b.astype(np.uint32))
    assert np.array_equal(_canon_t(F, out), _canon_j(jit, jout))
    rinv = pow(1 << (16 * L), -1, p)
    got = limbs_to_ints(out)
    assert [g % p for g in got] == [x * y * rinv % p for x, y in zip(av, bv)]
    assert int(out.max()) <= 0xFFFF and max(got) < p + p // 10
    c, _ = _lazy_limbs(p, L, N, rng, 8)
    at, bt, ct = (torch.from_numpy(v) for v in (a, b, c))
    many = F.mul_many([(at, bt), (bt, ct), (ct, at)])
    for m, (x, y) in zip(many, [(a, b), (b, c), (c, a)]):
        ref = jit["mul"](x.astype(np.uint32), y.astype(np.uint32))
        assert np.array_equal(_canon_t(F, m), _canon_j(jit, ref))


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_add_sub_canon_match_jax(which):
    """Lazy and exact sub, add and canon equal kzg_tpu's on the same
    limbs and the python-int results."""
    F, _, jit = _fields(which)
    p, L = F.modulus, F.L
    rng = np.random.default_rng(SEED + 1)
    av = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(N)]
    bv = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(N)]
    av[0], bv[1], av[2], bv[2] = 0, 0, p - 1, p - 1
    a = F.encode(av)
    b = F.encode(bv)
    ja, jb = a.numpy().astype(np.uint32), b.numpy().astype(np.uint32)
    for lazy in (True, False):
        got = F.sub(a, b, k=16, lazy=lazy)
        ref = jit[("sub", lazy)](ja, jb)
        assert np.array_equal(_canon_t(F, got), _canon_j(jit, ref))
        assert F.decode(got) == [(x - y) % p for x, y in zip(av, bv)]
    s = F.add(F.add(a, b), a)
    assert np.array_equal(_canon_t(F, s),
                          _canon_j(jit, jit["add"](jit["add"](ja, jb), ja)))
    assert F.decode(F.neg(a)) == [(-x) % p for x in av]
    # canon of raw limbs: value < 2 p, limbs up to 2^22 - 1
    raw, vals = _lazy_limbs(p, L, N, rng, 2)
    got = F.canon(torch.from_numpy(raw)).numpy()
    ref = np.asarray(jit["raw_canon"](raw.astype(np.uint32)))
    assert np.array_equal(got, ref.astype(np.int64))
    assert limbs_to_ints(got) == [v % p for v in vals]


@pytest.mark.parametrize("which", ["fp", "fr"])
def test_inv_batch_inv_match_jax(which):
    F, _, jit = _fields(which)
    p = F.modulus
    rng = np.random.default_rng(SEED + 2)
    av = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(9)]
    av[0] = 0
    av[4] = 1
    a = F.encode(av)
    ja = a.numpy().astype(np.uint32)
    exp = [0 if x == 0 else pow(x, -1, p) for x in av]
    inv = F.inv(a)
    assert np.array_equal(_canon_t(F, inv), _canon_j(jit, jit["inv"](ja)))
    assert F.decode(inv) == exp
    binv = F.batch_inv(a)
    assert np.array_equal(_canon_t(F, binv),
                          _canon_j(jit, jit["batch_inv"](ja)))
    assert F.decode(binv) == exp


def test_fp2_mul_inv_match_jax():
    cp = get_curve("BN254")
    F = Field(cp.fp, "cpu")
    F2 = Fp2(F, cp.qnr)
    jF2 = JFp2(JField(jax_curve("BN254").fp), cp.qnr)
    tw = Tower(cp)
    p = cp.p
    rng = np.random.default_rng(SEED + 3)

    def rnd():
        return int.from_bytes(rng.bytes(40), "little") % p

    av = [(rnd(), rnd()) for _ in range(12)]
    bv = [(rnd(), rnd()) for _ in range(12)]
    av[0] = (0, 0)
    bv[1] = (1, 0)
    av[2] = (0, p - 1)
    a, b = F2.encode(av), F2.encode(bv)
    ja, jb = a.numpy().astype(np.uint32), b.numpy().astype(np.uint32)

    def canon2(x):
        return F2.canon(F2.from_mont(x)).numpy()

    jit_canon = jax.jit(lambda y: jF2.canon(jF2.from_mont(y)))

    def jcanon2(x):
        return np.asarray(jit_canon(x)).astype(np.int64)

    prod = F2.mul(a, b)
    assert np.array_equal(canon2(prod), jcanon2(jax.jit(jF2.mul)(ja, jb)))
    assert F2.decode(prod) == [tw.e2_mul(x, y) for x, y in zip(av, bv)]
    inv = F2.inv(a)
    assert np.array_equal(canon2(inv), jcanon2(jax.jit(jF2.inv)(ja)))
    assert F2.decode(inv) == [(0, 0) if x == (0, 0) else tw.e2_inv(x)
                              for x in av]


def test_mul_wrapper_raises_off_the_card():
    """The K1 wrapper launches on CUDA tensors only; it never falls back to
    the plain version for a CPU tensor."""
    F = _fields("fr")[0]
    a = F.encode([1, 2, 3])
    before = cuda.counts()
    with pytest.raises(RuntimeError, match="kernel needs cuda"):
        cuda.mont_mul(F, a, a)
    assert cuda.counts() == before
