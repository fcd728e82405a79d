"""The port's CLI (kzg_tpu_torch.cli, the reference's kzg-cli contract), its
hex codecs, and proofs above MULTIEVAL_DIRECT points (the subproduct-tree
branch of PolyEngine.multieval) on the CPU.

The CLI runs in-process (cli.main(argv, device="cpu")) from a temporary
peer directory beside a shared/ that holds the golden 48-term BN254 setup
(secret 0xbeefcafe0123) as kzg_public; its commitment and proof bytes are
held to the python-int oracle's [p(s)] G1 and [q(s)] G1 serialized by
kzg_tpu. The tree branch is held to the golden proof bytes and to the direct
branch. Every comparison is exact.
"""

import contextlib
import functools
import io
import json
import math
import os
import shutil

import pytest
import torch

import kzg_tpu_torch as kzg
from kzg_tpu_torch import cli
from kzg_tpu_torch.ops import poly as tpoly
from kzg_tpu_torch.protocol import serial as tserial

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "fixtures", "golden")
with open(os.path.join(GOLDEN, "golden_BN254.json")) as _f:
    VEC = json.load(_f)
SECRET = int(VEC["secret"], 16)
CHUNK = 31                          # BN254: CURVE_ORDER_BYTES - 1
FILE_BYTES = 7 * CHUNK + 5          # 7 whole chunks: prove picks seed % 3
SEED = 5


@pytest.mark.parametrize("s", ["", "0", "abc", "00ff10", " 1a2b3 \n",
                               "DEADbeef"])
def test_hex_matches_kzg_tpu(s):
    """to_hex / from_hex equal kzg_tpu's, odd lengths (a "0" appended after
    stripping) included."""
    from kzg_tpu.protocol import serial as jserial
    assert tserial.from_hex(s) == jserial.from_hex(s)
    b = jserial.from_hex(s)
    assert tserial.to_hex(b) == jserial.to_hex(b)


def _run(argv, cwd):
    """cli.main on the CPU in `cwd`: (exit code, stdout)."""
    out = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv, device="cpu")
    finally:
        os.chdir(old)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def peer(tmp_path_factory):
    """A peer/ beside a shared/ holding the golden setup, and a data file of
    FILE_BYTES bytes in peer/."""
    root = tmp_path_factory.mktemp("cli")
    (root / "peer").mkdir()
    (root / "shared").mkdir()
    shutil.copy(os.path.join(GOLDEN, VEC["setup_file"]),
                root / "shared" / "kzg_public")
    data = bytes((7 * i + 3) % 256 for i in range(FILE_BYTES))
    (root / "peer" / "data.bin").write_bytes(data)
    return root / "peer", data


def _oracle_points(data):
    """The oracle's commitment [p(s)] G1 and proof [q(s)] G1 of the CLI's
    commit and prove on `data`, serialized by kzg_tpu: p interpolates the
    little-endian 31-byte chunks of the padded file at 0, 1, ...; the proof
    is of the 4 chunks from SEED % (chunks - 4)."""
    from kzg_tpu.curves.params import get_curve
    from kzg_tpu.protocol import serial as jserial
    from kzg_tpu.refmodel.model import G1
    cp = get_curve("BN254")
    r, og = cp.r, G1(cp)
    padded = data + b"\x00" * (CHUNK - len(data) % CHUNK)
    ys = jserial.pack_chunks(padded, len(padded) // CHUNK, CHUNK)

    def interp_at(xs, vals, x):
        tot = 0
        for j, xj in enumerate(xs):
            num = den = 1
            for k, xk in enumerate(xs):
                if k != j:
                    num, den = num * (x - xk) % r, den * (xj - xk) % r
            tot += vals[j] * num * pow(den, -1, r)
        return tot % r

    xs = list(range(len(ys)))
    ps = interp_at(xs, ys, SECRET)
    off = SEED % (len(data) // CHUNK - 4)
    pts = xs[off:off + 4]
    i_s = interp_at(pts, ys[off:off + 4], SECRET)
    z = math.prod(SECRET - x for x in pts) % r
    q = (ps - i_s) * pow(z, -1, r) % r
    return (jserial.serialize_g1(og.mul(ps, og.gen), cp),
            jserial.serialize_g1(og.mul(q, og.gen), cp), off,
            padded[off * CHUNK:(off + 4) * CHUNK])


def test_cli_commit_prove_verify_match_oracle(peer, monkeypatch):
    """commit and prove print the oracle's bytes; verify exits 0 on the
    proof's data and 1 on a flipped byte; a bare call exits 2. The commands
    share one load of the setup (cli._setup memoized), so the refutation
    reuses the shifted bases the first verify built."""
    cwd, data = peer
    monkeypatch.setattr(cli, "_setup", functools.cache(cli._setup))
    want_c, want_p, off, sub = _oracle_points(data)
    rc, out = _run(["commit", "data.bin"], cwd)
    assert rc == 0 and out == want_c.hex() + "\n"
    rc, out = _run(["prove", "data.bin", str(SEED)], cwd)
    assert rc == 0 and out == f"{want_p.hex()} {off} {sub.hex()}\n"
    proof_hex, off_s, data_hex = out.split()
    assert _run(["verify", want_c.hex(), proof_hex, off_s, data_hex],
                cwd) == (0, "")
    bad = bytearray(sub)
    bad[3] ^= 1
    assert _run(["verify", want_c.hex(), proof_hex, off_s, bad.hex()],
                cwd) == (1, "")
    assert _run([], cwd)[0] == 2


@pytest.mark.parametrize("n", [CHUNK, CHUNK + 4])
def test_load_file_padded_matches_kzg_tpu(tmp_path, n):
    """The reference's padding: up to the next multiple of the chunk, and a
    whole chunk of zeros when the length is one already."""
    from kzg_tpu import cli as jcli
    f = tmp_path / "data.bin"
    f.write_bytes(bytes(range(n)))
    got = cli._load_file_padded(str(f), CHUNK)
    assert got == jcli._load_file_padded(str(f), CHUNK)
    assert got == (bytes(range(n)) + b"\x00" * (2 * CHUNK - n), n)


def test_cli_setup_exports_a_setup_that_reloads(tmp_path):
    """--curve=BN158 setup 8 prints the reference's three lines and writes
    kzg_public in the working directory; it reloads as 8 G1 and 8 G2
    points from the generators."""
    rc, out = _run(["--curve=BN158", "setup", "8"], tmp_path)
    pc = kzg.init("BN158", device="cpu")
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 3
    assert lines[0].startswith("KZG trusted setup generated in ")
    assert lines[1:] == ["  num_coeff=8",
                         f"  max_commit_bytes={8 * kzg.MAX_CHUNK_BYTES}"]
    ts = kzg.trusted_setup(str(tmp_path / "kzg_public"))
    assert len(ts._g1) == len(ts._g2) == 8
    assert ts._g1[0] == pc.og1.gen and ts._g2[0] == pc.og2.gen


@pytest.fixture(scope="module")
def golden():
    kzg.init("BN254", device="cpu")
    ts = kzg.trusted_setup(os.path.join(GOLDEN, VEC["setup_file"]))
    p = kzg.poly.from_blob(kzg.blob.from_string(VEC["message"]))
    return ts, p


def test_tree_branch_proof_bytes(golden, monkeypatch):
    """With MULTIEVAL_DIRECT at 1, every segment of 2 points or more takes
    the subproduct tree; the golden proof of 38 points (32 + 4 + 2) reaches
    every level: its bytes, and the direct branch's evaluations."""
    ts, p = golden
    pr = max(VEC["proofs"], key=lambda v: v["chunk_length"])
    off, k = pr["chunk_offset"], pr["chunk_length"]
    assert k == 38
    pe = ts._pc.poly
    om = ts._pc.ctx.fr.encode([off])[..., 0]
    direct = pe.decode(pe.multieval(p.device_coeffs(ts._pc), om, k))
    monkeypatch.setattr(tpoly, "MULTIEVAL_DIRECT", 1)
    seen = []
    tree = pe.multieval

    def spy(*args):
        seen.append(tree(*args))
        return seen[-1]
    monkeypatch.setattr(pe, "multieval", spy)
    got = ts.create_proof(p, off, k)
    assert got.serialize().hex() == pr["proof_hex"]
    assert len(seen) == 1 and pe.decode(seen[0]) == direct


@pytest.mark.slow
def test_demo_on_cpu(monkeypatch):
    """The demo (a copy of demo/, its kzg-cli the port's CLI on the CPU) at
    a 48-term setup: exit 0, both hours' storage proofs VALID (~1 min)."""
    from kzg_tpu_torch.demo import run_demo
    monkeypatch.setenv("SETUP_TERMS", "48")
    rc, out = run_demo(device="cpu", timeout=900)
    assert rc == 0, out
    assert out.strip().splitlines()[-1] == "demo complete"
    assert out.count("storage proof VALID") == 2
