"""The port's BN158 slice (kzg_tpu_torch on curve BN158) on the CPU, held to
kzg_tpu's exact oracle (refmodel KZGOracle), its serializer and its NTT.

BN158 is the JAX package's own 158-bit BN curve (no reference build has
its bytes, so there is no golden file): Fp and Fr have 11 limbs (kernels
K1-K6 at 11 limbs on the card; here their plain versions), G1 has b = 13
(3b = 39, a full product in the point formulas), Fp2 has qnr = 5, the
twist is an M-twist, and Fr has 2-adicity 17, so every polynomial product
above 4 coefficients takes the NTT. The setup is the oracle's, carried
across by convert.setup_from_arrays (setup generation's comb costs ~5 s
on a CPU; the card runs it in chip_smoke.py). Every comparison is exact:
bytes, canonical field values and booleans. Verify with its refutation
costs ~6 s or more on a CPU, so it is marked slow; chip_smoke.py runs it
on the card in every run.
"""

import jax
import numpy as np
import pytest
import torch

import kzg_tpu_torch as kzg
from kzg_tpu.curves.params import get_curve as jax_curve
from kzg_tpu.fields.mont import Field as JField
from kzg_tpu.ops.poly import PolyEngine as JPolyEngine
from kzg_tpu.protocol import serial as jax_serial
from kzg_tpu.refmodel.model import KZGOracle
from kzg_tpu_torch import convert
from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.ops.poly import PolyEngine
from test_torch_bls import _packed

torch.set_num_threads(2)

CURVE = "BN158"
SEED = 20261020
SECRET = 0xC0FFEE_1234_5678_9ABC_DEF0
N_SETUP = 8
MESSAGE = "curves!"


@pytest.fixture(scope="module")
def carried():
    """An 8-term setup of the oracle, carried across; the message's
    polynomial (degree 6)."""
    kzg.init(CURVE, device="cpu")
    orc = KZGOracle(CURVE)
    g1s, g2s = orc.setup(N_SETUP, SECRET)
    L = jax_curve(CURVE).fp.n_limbs
    ts = convert.setup_from_arrays(_packed(g1s, L, False),
                                   _packed(g2s, L, True), device="cpu")
    assert ts._g1 == g1s and ts._g2 == g2s
    p = kzg.poly.from_blob(kzg.blob.from_string(MESSAGE))
    return orc, g1s, g2s, ts, p


def test_commit_and_proofs_match_the_oracle(carried):
    """init("BN158") builds 11-limb fields with qnr = 5; from_blob (its
    subproduct tree on the NTT), the commitment and the proofs of (1, 3)
    and (0, 1) give the oracle's points and kzg_tpu's bytes for them."""
    orc, g1s, _, ts, p = carried
    ctx = get_context(CURVE, "cpu")
    assert ctx.fp.L == ctx.fr.L == 11 and ctx.fp2.qnr_small == 5
    jcp = jax_curve(CURVE)
    assert p.coeffs == orc.poly.interpolate(
        list(range(len(MESSAGE))), [ord(ch) for ch in MESSAGE])
    c = ts.create_commit(p)
    want = orc.commit(p.coeffs, g1s)
    assert c.curve_point == want
    assert c.serialize() == jax_serial.serialize_g1(want, jcp)
    for off, ln in ((1, 3), (0, 1)):
        pr = ts.create_proof(p, off, ln)
        want = orc.create_proof(p.coeffs, off, ln, g1s)
        assert pr.curve_point == want
        assert pr.serialize() == jax_serial.serialize_g1(want, jcp)


def test_setup_from_arrays_takes_11_limbs(carried):
    """convert.setup_from_arrays reads BN158's 11-limb packed arrays (2 L
    + 1 = 23 rows for G1, 4 L + 1 = 45 for G2) and refuses 17-limb ones,
    a coordinate at p and a point off the curve."""
    orc, g1s, g2s, _, _ = carried
    a1, a2 = _packed(g1s, 11, False), _packed(g2s, 11, True)
    assert a1.shape == (23, N_SETUP) and a2.shape == (45, N_SETUP)
    with pytest.raises(ValueError, match="shape"):
        convert.setup_from_arrays(_packed(g1s, 17, False),
                                  _packed(g2s, 17, True))
    p = jax_curve(CURVE).p
    for bad in ([(p, g1s[1][1])], [(g1s[1][0], g1s[1][1] + 1)]):
        with pytest.raises(ValueError, match="curve"):
            convert.setup_from_arrays(_packed(g1s[:1] + bad, 11, False),
                                      _packed(g2s[:2], 11, True))


@pytest.mark.slow
def test_verify_and_refute(carried):
    """The proof of (1, 3) verifies (BN158's Miller loop: a BN loop and
    tail with M-twist lines); one changed byte is refuted."""
    orc, _, _, ts, p = carried
    c = ts.create_commit(p)
    pr = ts.create_proof(p, 1, 3)
    assert ts.verify_proof(c, pr, kzg.blob.from_string(MESSAGE[1:4], 1))
    assert not ts.verify_proof(c, pr, kzg.blob.from_string("uzv", 1))


def test_ntt_matches_kzg_tpu():
    """At k = 4 (16 points, a batch of 2) on BN158's Fr (2-adicity 17):
    the forward NTT equals kzg_tpu's PolyEngine.ntt (jitted) and the
    python-int DFT with kzg_tpu's root of unity, and the inverse NTT
    returns the input."""
    ctx = get_context(CURVE, "cpu")
    F, cp = ctx.fr, ctx.cp
    r, L, n = cp.r, F.L, 16
    assert cp.fr_two_adicity == 17
    jcp = jax_curve(CURVE)
    jpe = JPolyEngine(JField(jcp.fr), jcp)
    pe = PolyEngine(F, cp)
    rng = np.random.default_rng(SEED)
    rows = [[int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
            for _ in range(2)]
    x = F.encode(rows[0] + rows[1]).reshape(L, 2, n)
    fwd = pe.ntt(x)
    jfwd = np.asarray(jax.jit(jpe.ntt)(x.numpy().astype(np.uint32)))
    got = [F.decode(fwd[:, i]) for i in range(2)]
    assert got == [F.decode(torch.from_numpy(jfwd[:, i].astype(np.int64)))
                   for i in range(2)]
    w = jcp.ntt_root(4)
    assert w == cp.ntt_root(4) and pow(w, 8, r) == r - 1
    assert got == [[sum(v * pow(w, i * j, r) for i, v in enumerate(row)) % r
                    for j in range(n)] for row in rows]
    assert [F.decode(pe.ntt(fwd, inverse=True)[:, i])
            for i in range(2)] == rows
