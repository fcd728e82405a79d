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
    """kzg_tpu's own affine_packed arrays of a 24-term setup, carried across
    by convert.setup_from_arrays, hold the same points and commit to the
    point of kzg_tpu's exact reference (refmodel KZGOracle). That the port's
    MSM equals kzg_tpu's MSM engine is held in tests/test_torch_msm.py."""
    n_setup, n = 24, 11
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
        assert (ts.create_proof(q, 4, 8, cs).curve_point
                == ts.create_proof(q, 4 // cs, 8 // cs).curve_point)
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
    card it raises instead of falling back; unported curves raise."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kzg.init("BN254")
        with pytest.raises(RuntimeError, match="CUDA"):
            get_context("BN254")
    with pytest.raises(NotImplementedError):
        kzg.init("BN158", device="cpu")
    with pytest.raises(ValueError):
        kzg.init("BN254", device="meta")


def test_constants_equal_kzg_tpu():
    for name in CURVE_NAMES:
        assert dataclasses.asdict(get_curve(name)) == \
            dataclasses.asdict(jax_curve(name))


def test_imports_no_jax():
    """In a fresh interpreter the port commits on the CPU without loading
    any jax module or anything of kzg_tpu."""
    code = (
        "import sys, json\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import kzg_tpu_torch as kzg\n"
        "kzg.init('BN254', device='cpu')\n"
        f"ts = kzg.trusted_setup({SETUP_FILE!r})\n"
        "p = kzg.poly.from_blob(kzg.blob.from_string('hi'))\n"
        "c = ts.create_commit(p)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kzg_tpu'))\n"
        "print(json.dumps({'bad': bad, 'commit': c.serialize().hex()}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # beside the other test workers
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert len(bytes.fromhex(res["commit"])) == 4 + 2 * 32 + 1
