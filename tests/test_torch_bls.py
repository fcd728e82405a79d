"""The port's BLS12-381 slice (kzg_tpu_torch on curve BLS12381) on the CPU,
held to the golden vectors that tests/test_golden.py holds the JAX package
to, to kzg_tpu's own setup load and NTT, and to python-int arithmetic.

BLS12-381's Fp has 25 limbs (kernels K1-K5 at 25 limbs on the card; here
their plain versions) and its Fr 17; its Fr has 2-adicity 32, so every
polynomial product takes the NTT (kzg_tpu_torch/ops/poly.py PolyEngine.ntt,
the JAX package's rule). The golden bytes (tests/fixtures/golden/
golden_BLS12381.json) come from the 48-term setup file kzg_public_BLS12381
generated with secret 0xbeefcafe0123. Every comparison is exact: bytes,
canonical field values and booleans. The golden verify with its
refutation costs 15-21 s on a CPU, so it is marked slow; chip_smoke.py runs
it on the card in every run.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import kzg_tpu_torch as kzg
from kzg_tpu.curves.params import get_curve as jax_curve
from kzg_tpu.fields.mont import Field as JField
from kzg_tpu.fields.mont import ints_to_limbs as jax_ints_to_limbs
from kzg_tpu.ops.poly import PolyEngine as JPolyEngine
from kzg_tpu.protocol import serial as jax_serial
from kzg_tpu_torch import convert
from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.ops.poly import PolyEngine

torch.set_num_threads(2)

CURVE = "BLS12381"
SEED = 20261019
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "fixtures", "golden")
with open(os.path.join(GOLDEN, f"golden_{CURVE}.json")) as _f:
    VEC = json.load(_f)
SETUP_FILE = os.path.join(GOLDEN, VEC["setup_file"])


def _packed(points, L, fp2):
    """kzg_tpu's host affine points -> the (C*2*L + 1, n) canonical layout
    of its Curve.affine_packed (x limbs, y limbs, infinity flag), numpy."""
    comps = 2 if fp2 else 1

    def coord(i):
        vals = [(0,) * comps if P is None else (P[i] if fp2 else (P[i],))
                for P in points]
        return [jax_ints_to_limbs([v[c] for v in vals], L)
                for c in range(comps)]

    inf = np.array([[P is None for P in points]], dtype=np.uint32)
    return np.concatenate(coord(0) + coord(1) + [inf], axis=0)


@pytest.fixture(scope="module")
def golden():
    """The 48-term setup as kzg_tpu loads it, carried across by
    convert.setup_from_arrays, and the port's own load of the same file;
    the golden message's polynomial."""
    kzg.init(CURVE, device="cpu")
    jcp = jax_curve(CURVE)
    g1, g2 = jax_serial.read_setup_file(SETUP_FILE, jcp)
    L = jcp.fp.n_limbs
    ts = convert.setup_from_arrays(_packed(g1, L, False),
                                   _packed(g2, L, True), device="cpu")
    own = kzg.trusted_setup(SETUP_FILE)
    p = kzg.poly.from_blob(kzg.blob.from_string(VEC["message"]))
    return ts, own, p


def test_golden_poly_and_commit_bytes(golden):
    """The carried setup holds the port's own load's points; poly and
    commitment bytes are the golden ones (the poly through the NTT)."""
    ts, own, p = golden
    assert ts._g1 == own._g1 and ts._g2 == own._g2
    assert len(ts._g1) == VEC["num_coeff"]
    assert p.serialize().hex() == VEC["poly_hex"]
    c = ts.create_commit(p)
    assert c.serialize().hex() == VEC["commit_hex"]
    assert kzg.poly.deserialize(p.serialize()).coeffs == p.coeffs


@pytest.mark.parametrize("i", range(len(VEC["proofs"])))
def test_golden_proof_bytes(golden, i):
    ts, _, p = golden
    pr = VEC["proofs"][i]
    got = ts.create_proof(p, pr["chunk_offset"], pr["chunk_length"])
    assert got.serialize().hex() == pr["proof_hex"]


@pytest.mark.slow
def test_golden_verify_and_refute(golden):
    """The whole-message proof verifies (BLS12-381's Miller loop: negative
    loop scalar, M-twist lines, no BN tail); one changed byte is
    refuted."""
    ts, _, _ = golden
    msg = VEC["message"]
    pr = VEC["proofs"][-1]
    off, ln = pr["chunk_offset"], pr["chunk_length"]
    c = kzg.commit.deserialize(bytes.fromhex(VEC["commit_hex"]))
    proof = kzg.proof.deserialize(bytes.fromhex(pr["proof_hex"]))
    assert ts.verify_proof(c, proof, kzg.blob.from_string(msg[off:off + ln],
                                                          off))
    bad = msg[:5] + chr(ord(msg[5]) ^ 1) + msg[6:]
    assert not ts.verify_proof(c, proof,
                               kzg.blob.from_string(bad[off:off + ln], off))


def test_ntt_matches_kzg_tpu_and_a_dft():
    """At k = 4 (16 points, a batch of 2): the forward NTT equals kzg_tpu's
    PolyEngine.ntt (jitted) and the python-int DFT with kzg_tpu's root of
    unity, the inverse NTT returns the input, and the NTT convolution (the
    one conv takes on BLS12-381 above 4 coefficients) equals Karatsuba and
    the schoolbook product mod r."""
    ctx = get_context(CURVE, "cpu")
    F, cp = ctx.fr, ctx.cp
    r, L, n = cp.r, F.L, 16
    jcp = jax_curve(CURVE)
    jpe = JPolyEngine(JField(jcp.fr), jcp)
    pe = PolyEngine(F, cp)
    rng = np.random.default_rng(SEED)

    def rand(m):
        return [int.from_bytes(rng.bytes(40), "little") % r
                for _ in range(m)]

    rows = [rand(n), rand(n)]
    x = F.encode(rows[0] + rows[1]).reshape(L, 2, n)
    fwd = pe.ntt(x)
    jfwd = jax.jit(jpe.ntt)(x.numpy().astype(np.uint32))
    got = [F.decode(fwd[:, i]) for i in range(2)]
    assert got == [F.decode(torch.from_numpy(np.asarray(jfwd)[:, i]
                                             .astype(np.int64)))
                   for i in range(2)]
    w = jcp.ntt_root(4)
    assert w == cp.ntt_root(4) and pow(w, 8, r) == r - 1
    assert got == [[sum(v * pow(w, i * j, r) for i, v in enumerate(row)) % r
                    for j in range(n)] for row in rows]
    assert [F.decode(pe.ntt(fwd, inverse=True)[:, i])
            for i in range(2)] == rows
    a, b = rand(9), rand(8)
    ta, tb = F.encode(a), F.encode(b)
    ntt = pe.conv(ta, tb)
    kara = F.freshen(pe._conv_kara(pe._pad_last(ta, n), pe._pad_last(tb, n))
                     [..., :16])
    school = [sum(a[i] * b[k - i] for i in range(len(a)) if 0 <= k - i
                  < len(b)) % r for k in range(16)]
    assert F.decode(ntt) == F.decode(kara) == school


def test_init_device_rules():
    """init("BLS12381") runs on the CPU when asked and on the card by
    default, raising without one; BN158 initialises with its 11-limb
    fields, and an unknown curve raises ValueError."""
    pc = kzg.init(CURVE, device="cpu")
    assert pc.ctx.fp.L == 25 and pc.ctx.fr.L == 17
    assert kzg.CURVE_ORDER_BYTES == 32 and kzg.MAX_CHUNK_BYTES == 31
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kzg.init(CURVE)
    pc = kzg.init("BN158", device="cpu")
    assert pc.ctx.fp.L == pc.ctx.fr.L == 11
    with pytest.raises(ValueError):
        kzg.init("BLS12-377", device="cpu")
    kzg.init(CURVE, device="cpu")
