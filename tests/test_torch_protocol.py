"""The port's protocol slice (kzg_tpu_torch: setup -> from_blob -> commit ->
proof -> verify) on the CPU, held to the same golden vectors that
tests/test_golden.py holds the JAX package to, plus the JAX package's own
setup arrays carried across by kzg_tpu_torch.convert, the reference's error
semantics, and the port's isolation from JAX.

The golden bytes (tests/fixtures/golden/golden_BN254.json) come from the
48-term setup file kzg_public_BN254 generated with secret 0xbeefcafe0123.
Every comparison is exact: bytes, canonical affine points and booleans.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import kzg_tpu_torch as kzg
from kzg_tpu.context import get_context as jax_context
from kzg_tpu.curves.params import get_curve as jax_curve
from kzg_tpu.refmodel.model import KZGOracle
from kzg_tpu_torch import convert
from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.curves.params import CURVE_NAMES, get_curve

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "fixtures", "golden")
ROOT = os.path.dirname(HERE)
with open(os.path.join(GOLDEN, "golden_BN254.json")) as _f:
    VEC = json.load(_f)
SETUP_FILE = os.path.join(GOLDEN, VEC["setup_file"])


@pytest.fixture(scope="module")
def golden():
    kzg.init("BN254", device="cpu")
    ts = kzg.trusted_setup(SETUP_FILE)
    p = kzg.poly.from_blob(kzg.blob.from_string(VEC["message"]))
    return ts, p


def test_golden_poly_and_commit_bytes(golden):
    ts, p = golden
    assert p.serialize().hex() == VEC["poly_hex"]
    c = ts.create_commit(p)
    assert c.serialize().hex() == VEC["commit_hex"]
    assert ts.verify_commit(c, p)
    assert kzg.poly.deserialize(p.serialize()).coeffs == p.coeffs


@pytest.mark.parametrize("i", range(len(VEC["proofs"])))
def test_golden_proof_bytes(golden, i):
    ts, p = golden
    pr = VEC["proofs"][i]
    got = ts.create_proof(p, pr["chunk_offset"], pr["chunk_length"])
    assert got.serialize().hex() == pr["proof_hex"]


def test_golden_verify_and_refute(golden):
    """The whole-message proof verifies; one changed byte is refuted."""
    ts, p = golden
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


def test_pairing_check_holds_when_the_miller_point_has_a_wide_y():
    """e([a] G2, [b] G1) == e(G2, [a b] G1) holds for the scalars of a
    storage proof of the demo's document (a = Z(s), b = q(s)), whose Miller
    loop ends with T's lazy y past 8 p. BN254's loop scalar 6u + 2 is
    negative, so T is negated before the two Frobenius steps; a negation
    with 8 p of slack borrowed there and refuted the valid proof (as
    kzg_tpu's engine, which shares that negation, still does). Points come
    from the python oracle."""
    from kzg_tpu_torch.pairing.engine import PairingEngine
    from kzg_tpu_torch.refmodel.model import G1, G2
    cp = get_curve("BN254")
    ctx = get_context("BN254", device="cpu")
    eng = PairingEngine(ctx)
    og1, og2 = G1(cp), G2(cp)
    a = 0xcec23b30e5aa9b7002b56f7d78b69328d4e78a1a48f4aef87bbabde122eff85
    b = 0x36d35d02275fee6ea216b78cf066f9e975a17ffadedbaf1521e48c2f34b49ff

    def pt(G, P):
        return {k: v[..., 0] for k, v in G.encode_points([P]).items()}

    Qa, Pa = pt(ctx.g2, og2.mul(a, og2.gen)), pt(ctx.g1, og1.mul(b, og1.gen))
    Qb, Pb = pt(ctx.g2, og2.gen), pt(ctx.g1, og1.mul(a * b % cp.r, og1.gen))
    assert bool(eng.pairing_check(Qa, Pa, Qb, Pb).item())


def test_from_secret_exports_golden_file(golden, tmp_path):
    """Setup generation (the comb, with its oracle self-check) reproduces
    the golden setup file byte for byte."""
    ts = kzg.trusted_setup.from_secret(int(VEC["secret"], 16),
                                       VEC["num_coeff"])
    path = str(tmp_path / "kzg_public")
    ts.export_setup(path)
    with open(path, "rb") as a, open(SETUP_FILE, "rb") as b:
        assert a.read() == b.read()


def test_setup_from_arrays_commits_like_kzg_tpu(golden):
    """kzg_tpu's own affine_packed arrays of a 12-term setup (the least that
    takes an 11-coefficient polynomial), carried across by
    convert.setup_from_arrays, hold the same points and commit to the point
    of kzg_tpu's exact reference (refmodel KZGOracle). That the port's MSM
    equals kzg_tpu's MSM engine is held in tests/test_torch_msm.py."""
    n_setup, n = 12, 11
    secret = 0xC0FFEE_1234_5678_9ABC_DEF0
    g1s, g2s = KZGOracle("BN254").setup(n_setup, secret)
    jctx = jax_context("BN254")
    P1 = jctx.g1.encode_points(g1s)
    a1 = np.asarray(jax.jit(jctx.g1.affine_packed)(P1))
    a2 = np.asarray(jax.jit(jctx.g2.affine_packed)(
        jctx.g2.encode_points(g2s)))
    assert a1.dtype == np.uint32 and a1.shape == (2 * 17 + 1, n_setup)
    assert a2.shape == (4 * 17 + 1, n_setup)
    ts = convert.setup_from_arrays(a1, a2, device="cpu")
    assert ts._g1 == g1s and ts._g2 == g2s
    data = "carry across"[:n]
    p = kzg.poly.from_blob(kzg.blob.from_string(data))
    got = ts.create_commit(p)
    assert got.curve_point == KZGOracle("BN254").commit(p.coeffs, g1s)
    with pytest.raises(ValueError):
        convert.setup_from_arrays(a1[:-1], a2)
    bad = a1.copy()
    bad[0, 3] ^= 1                                 # off the curve
    with pytest.raises(ValueError):
        convert.setup_from_arrays(bad, a2)


def test_error_semantics(golden):
    """The reference's ValueError / RuntimeError cases (mirroring
    tests/test_protocol.py) on the 48-term golden setup."""
    ts, _ = golden
    with pytest.raises(ValueError):
        kzg.trusted_setup(0)
    with pytest.raises(ValueError):
        kzg.trusted_setup.from_secret(5, 1)
    with pytest.raises(RuntimeError):
        kzg.trusted_setup(os.path.join(GOLDEN, "missing"))
    p = kzg.poly.from_blob(kzg.blob.from_string("some data"))
    with pytest.raises(ValueError):                 # empty proof
        ts.create_proof(p, 5, 0)
    c = ts.create_commit(p)
    pr = ts.create_proof(p, 3, 2)
    with pytest.raises(ValueError):                 # empty verify
        ts.verify_proof(c, pr, kzg.blob.from_string("", 3))
    # as long as the setup: refuted, not thrown
    assert not ts.verify_proof(c, pr, kzg.blob.from_string("x" * 48, 0))
    with pytest.raises(ValueError):                 # degree too high
        ts.create_commit(kzg.poly.from_blob(kzg.blob.from_string(
            "".join(chr(48 + 7 * i % 75) for i in range(48)))))
    assert ts.create_commit(kzg.poly([])).curve_point is None
    assert kzg.poly.from_blob(kzg.blob.from_string("")).coeffs == []
    # chunking (>= 17 terms, unlike the 16-term setup of test_chunking)
    data = bytes(range(65, 65 + 24))
    with pytest.raises(ValueError):
        kzg.blob.from_bytes(data, 0, len(data), 5)
    with pytest.raises(ValueError):
        kzg.blob.from_bytes(data, 0, len(data), 0)
    with pytest.raises(ValueError):
        kzg.blob.from_bytes(data, 0, len(data), kzg.MAX_CHUNK_BYTES + 1)
    for cs in (1, 2, 4):
        q = kzg.poly.from_blob(kzg.blob.from_bytes(data, 0, len(data), cs))
        assert q.degree < len(data) // cs
        got = ts.create_proof(q, 4, 8, cs).curve_point
        if cs > 1:            # with cs = 1 both calls take the same arguments
            assert got == ts.create_proof(q, 4 // cs, 8 // cs).curve_point
    # the reference quirk: data is read from the START of the buffer
    b0 = kzg.blob.from_bytes(data, 0, 8, 4)
    assert kzg.blob.from_bytes(data, 4, 8, 4).get_data() == \
        [(x + 1, y) for x, y in b0.get_data()]
    with pytest.raises(ValueError):
        ts.create_proof(p, 0, 5, 4)
    with pytest.raises(ValueError):
        ts.create_proof(p, 2, 8, 4)
    with pytest.raises(ValueError):
        ts.create_proof(p, 0, 8, kzg.MAX_CHUNK_BYTES + 1)


def test_init_device_rules():
    """init() runs on the card unless the caller asks for the CPU: without a
    card it raises instead of falling back; BN158 initialises with its
    11-limb fields, and an unknown curve raises ValueError."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kzg.init("BN254")
        with pytest.raises(RuntimeError, match="CUDA"):
            get_context("BN254")
    pc = kzg.init("BN158", device="cpu")
    assert pc.ctx.fp.L == pc.ctx.fr.L == 11
    with pytest.raises(ValueError):
        kzg.init("BN256", device="cpu")
    with pytest.raises(ValueError):
        kzg.init("BN254", device="meta")
    kzg.init("BN254", device="cpu")


def test_constants_equal_kzg_tpu():
    for name in CURVE_NAMES:
        assert dataclasses.asdict(get_curve(name)) == \
            dataclasses.asdict(jax_curve(name))


def test_imports_no_jax():
    """In a fresh interpreter the port (with its CLI, demo launcher,
    native codec library and multi-device modules imported) commits on the
    CPU and runs blob.from_bytes -> from_blob through the native library,
    which it builds under build/kzg_tpu_torch/ (not csrc/), without loading
    any jax module or anything of kzg_tpu."""
    code = (
        "import sys, json\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import kzg_tpu_torch as kzg\n"
        "import kzg_tpu_torch.cli, kzg_tpu_torch.demo, kzg_tpu_torch.native\n"
        "import kzg_tpu_torch.parallel.distributed\n"
        "import kzg_tpu_torch.parallel.sharded, kzg_tpu_torch.parallel.ntt\n"
        "kzg.init('BN254', device='cpu')\n"
        f"ts = kzg.trusted_setup({SETUP_FILE!r})\n"
        "p = kzg.poly.from_blob(kzg.blob.from_string('hi'))\n"
        "c = ts.create_commit(p)\n"
        "b = kzg.blob.from_bytes(bytes(range(62)), 31, 62, 31)\n"
        "q = kzg.poly.from_blob(b)\n"
        "so = str(kzg_tpu_torch.native.lib().path)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kzg_tpu'))\n"
        "print(json.dumps({'bad': bad, 'commit': c.serialize().hex(), "
        "'so': so, 'matrix': b._limbs is not None, "
        "'coeffs': [str(v) for v in q.coeffs]}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # beside the other test workers
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert len(bytes.fromhex(res["commit"])) == 4 + 2 * 32 + 1
    so = os.path.realpath(res["so"])
    assert os.path.dirname(so) == os.path.realpath(
        os.path.join(ROOT, "build", "kzg_tpu_torch"))
    assert not so.startswith(os.path.realpath(os.path.join(ROOT, "csrc")))
    ys = [int.from_bytes(bytes(range(31)), "little"),
          int.from_bytes(bytes(range(31, 62)), "little")]
    assert res["matrix"] and len(res["coeffs"]) == 2
    slope = (ys[1] - ys[0]) % get_curve("BN254").r
    assert [int(v) for v in res["coeffs"]] == [
        (ys[0] - slope) % get_curve("BN254").r, slope]
