"""The port's native codec library (kzg_tpu_torch/native.py over
kzg_tpu_torch/csrc/kzg_native.cpp) on the CPU.

Every bound method is held to kzg_tpu's library (kzg_tpu.native.lib, the
reference) and to the port's plain python codecs; a short buffer raises the
same ValueError in both packages; blob.from_bytes -> poly.from_blob through
the library's limb matrix gives the coefficients of the ints path. Inputs
come from numpy.random.default_rng; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import kzg_tpu_torch as kzg
from kzg_tpu_torch import native
from kzg_tpu_torch.fields.mont import ints_to_limbs, limbs_to_ints
from kzg_tpu_torch.protocol import serial as tserial

torch.set_num_threads(2)

SHORT = "buffer shorter than requested range"


def _jlib():
    from kzg_tpu.native import lib
    assert lib is not None, "kzg_tpu's native library did not load"
    return lib


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", [0, 1, 33, 4096])
def test_hex_matches_kzg_tpu(n):
    """hex_encode / hex_decode equal kzg_tpu's and the plain codecs, odd
    lengths drop the last digit as kzg_tpu's do, invalid digits raise."""
    lib, jlib = native.lib(), _jlib()
    b = _bytes(np.random.default_rng(n), n)
    h = lib.hex_encode(b)
    assert h == jlib.hex_encode(b) == tserial.to_hex(b)
    for s in (h, h.upper(), h + "7"):
        assert lib.hex_decode(s) == jlib.hex_decode(s) == b
    for bad in ("zz", h + "0g", "-1"):
        for codec in (lib, jlib):
            with pytest.raises(ValueError, match="invalid hex"):
                codec.hex_decode(bad)


@pytest.mark.parametrize("chunk_size", [1, 2, 3, 16, 19, 31])
def test_pack_chunks_matches_kzg_tpu(chunk_size):
    """pack_chunks (ints) and pack_chunks_limbs equal kzg_tpu's library and
    the plain serial.pack_chunks, reading from the start of a longer
    buffer; a wider matrix has zero rows on top."""
    from kzg_tpu.protocol import serial as jserial
    lib, jlib = native.lib(), _jlib()
    n = 37
    data = _bytes(np.random.default_rng(chunk_size), n * chunk_size + 5)
    ints = tserial.pack_chunks(data, n, chunk_size)
    assert ints == jserial.pack_chunks(data, n, chunk_size)
    assert lib.pack_chunks(data, n, chunk_size) == ints
    assert jlib.pack_chunks(data, n, chunk_size) == ints
    nl = (chunk_size + 1) // 2
    for width in (nl, nl + 1):
        mat = lib.pack_chunks_limbs(data, n, chunk_size, width)
        assert mat.dtype == np.uint32 and mat.shape == (width, n)
        assert np.array_equal(mat, jlib.pack_chunks_limbs(
            data, n, chunk_size, width))
        assert np.array_equal(mat, ints_to_limbs(ints, width))
        assert np.array_equal(mat, tserial.pack_chunks_limbs(
            data, n, chunk_size, width))
    assert limbs_to_ints(lib.pack_chunks_limbs(data, n, chunk_size,
                                               nl)) == ints


@pytest.mark.parametrize("width", [20, 32, 48])
def test_be_limbs_match_kzg_tpu(width):
    """be_to_limbs / limbs_to_be over records of BN158's, BN254's and
    BLS12-381's coordinate widths equal kzg_tpu's library and the plain
    int.from_bytes / to_bytes, at the full limb count and truncated."""
    lib, jlib = native.lib(), _jlib()
    n = 25
    recs = _bytes(np.random.default_rng(width), n * width)
    vals = [int.from_bytes(recs[i * width:(i + 1) * width], "big")
            for i in range(n)]
    for nl in ((width + 1) // 2, (width + 1) // 2 + 1, 4):
        mat = lib.be_to_limbs(recs, n, width, nl)
        assert np.array_equal(mat, jlib.be_to_limbs(recs, n, width, nl))
        assert np.array_equal(mat, ints_to_limbs(vals, nl))
    mat = lib.be_to_limbs(recs, n, width, (width + 1) // 2)
    back = lib.limbs_to_be(mat, width)
    assert back == jlib.limbs_to_be(mat, width) == recs
    assert back == b"".join(v.to_bytes(width, "big") for v in vals)


@pytest.mark.parametrize("width", [20, 32])
def test_poly_codec_matches_serialize_poly(width):
    """poly_encode of little-endian rows equals serialize_poly's bytes
    (zero coefficients inside, the zero polynomial as degree -1) and
    kzg_tpu's library; poly_decode gives the rows back and
    deserialize_poly's coefficients."""
    lib, jlib = native.lib(), _jlib()
    rng = np.random.default_rng(width)
    n = 41
    sizes = rng.integers(0, width + 1, n)
    sizes[-1] = width
    coeffs = [int.from_bytes(_bytes(rng, int(s)), "little") for s in sizes]
    coeffs[-1] |= 1 << (8 * width - 1)
    for c in (coeffs, []):
        rows = np.frombuffer(b"".join(v.to_bytes(width, "little")
                                      for v in c), np.uint8
                             ).reshape(len(c), width)
        enc = lib.poly_encode(rows)
        assert enc == jlib.poly_encode(rows) == tserial.serialize_poly(c)
        dec = lib.poly_decode(enc, width)
        assert np.array_equal(dec, rows)
        assert np.array_equal(dec, jlib.poly_decode(enc, width))
        assert [int.from_bytes(r.tobytes(), "little") for r in dec] == \
            tserial.deserialize_poly(enc)


_GOOD = (2).to_bytes(8, "little", signed=True) + b"\x01\x05\x00\x02\x01\x01"


@pytest.mark.parametrize("stream", [
    (-2).to_bytes(8, "little", signed=True),          # degree below -1
    _GOOD[:7],                                         # no whole degree
    _GOOD[:-1],                                        # truncated bytes
    _GOOD[:-3],                                        # a count is missing
    (0).to_bytes(8, "little") + b"\x05" + bytes(5),    # count above width
], ids=["degree", "header", "bytes", "count", "width"])
def test_poly_decode_malformed_raises(stream):
    """A malformed stream raises the same ValueError in both libraries
    (the width is 4 bytes)."""
    assert native.lib().poly_decode(_GOOD, 4).shape == (3, 4)
    for codec in (native.lib(), _jlib()):
        with pytest.raises(ValueError, match="malformed polynomial stream"):
            codec.poly_decode(stream, 4)


def test_short_buffer_raises():
    """A buffer shorter than chunk_length * chunk_size raises the same
    ValueError in the port's serial.pack_chunks, serial.pack_chunks_limbs,
    library and blob.from_bytes as in kzg_tpu's serial.pack_chunks."""
    from kzg_tpu.protocol import serial as jserial
    kzg.init("BN254", device="cpu")
    calls = [lambda: tserial.pack_chunks(b"abc", 2, 2),
             lambda: tserial.pack_chunks_limbs(b"abc", 2, 2, 1),
             lambda: native.lib().pack_chunks(b"abc", 2, 2),
             lambda: native.lib().be_to_limbs(b"abc", 2, 2, 1),
             lambda: kzg.blob.from_bytes(b"abc", 0, 4, 2),
             lambda: kzg.blob.from_bytes(bytes(123), 31, 124, 31),
             lambda: jserial.pack_chunks(b"abc", 2, 2)]
    for call in calls:
        with pytest.raises(ValueError, match=SHORT):
            call()
    assert tserial.pack_chunks(b"abcd", 2, 2) == [0x6261, 0x6463]


@pytest.mark.parametrize("curve", ["BN254", "BN158", "BLS12381"])
def test_from_bytes_matches_ints_path(curve):
    """from_bytes (the library's limb matrix, uploaded without ints) ->
    from_blob gives the coefficients of blob(pairs) -> from_blob (31-byte
    chunks in 16 of 17 limbs on BN254 and BLS12-381's Fr, 19-byte chunks
    in 10 of 11 on BN158); get_data() gives kzg_tpu's pairs; a blob's ys
    encode as fr.encode of its ints."""
    from kzg_tpu.protocol import serial as jserial
    pc = kzg.init(curve, device="cpu")
    size = kzg.MAX_CHUNK_BYTES
    n, off = 40, 3
    data = _bytes(np.random.default_rng(len(curve) + size), n * size + size - 1)
    b = kzg.blob.from_bytes(data, off * size, n * size, size)
    assert b._limbs.shape == ((size + 1) // 2, n)
    fr = pc.ctx.fr
    ys = jserial.pack_chunks(data, n, size)
    assert torch.equal(fr.canon(b._ys(fr)), fr.canon(fr.encode(ys)))
    p = kzg.poly.from_blob(b)
    pairs = [(off + i, y) for i, y in enumerate(ys)]
    assert b.get_data() == pairs and b._limbs is None
    assert p.coeffs == kzg.poly.from_blob(kzg.blob(pairs)).coeffs
    assert len(p.coeffs) == n


@pytest.mark.parametrize("cxx", ["kzg-no-such-compiler",
                                 "sh -c 'echo kzg-cxx-refused >&2; exit 3' cc"])
def test_build_failure_raises(cxx, tmp_path, monkeypatch):
    """A missing compiler or a failed build raises RuntimeError with the
    compiler's output and leaves no library behind; nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="not found|kzg-cxx-refused"):
        native.build()
    assert not list(tmp_path.rglob("*.so")) and \
        not list(tmp_path.rglob("*.tmp"))


def test_get_data_is_the_blob_from_then_on():
    """get_data() builds the (x, y) list once and drops the matrix: a change
    to that list reaches from_blob, as with a blob built from pairs."""
    kzg.init("BN158", device="cpu")
    b = kzg.blob.from_bytes(bytes(range(1, 77)), 0, 76, 19)
    pts = b.get_data()
    assert b.get_data() is pts and b._limbs is None and len(pts) == 4
    pts[2] = (2, 7)
    want = kzg.poly.from_blob(kzg.blob(list(pts))).coeffs
    assert kzg.poly.from_blob(b).coeffs == want


def test_library_name_follows_source_compiler_and_flags(monkeypatch):
    """lib() loads the library from build/kzg_tpu_torch/ under a name that
    hashes the source, the compiler and the flags."""
    so = native.lib().path
    assert so.parent == native.BUILD_DIR and so.name.startswith(
        "libkzg_native_") and so.suffix == ".so" and so.exists()
    assert native._so_path(native._compiler()) == so
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DX=1"])
    assert native._so_path(native._compiler()) != so
    monkeypatch.undo()
    monkeypatch.setenv("CXX", "c++ -g0")
    assert native._so_path(native._compiler()) != so


def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    """Nine threads (more than the cores the tests get) building at once
    into an empty directory each compile to a file of their own: all get
    one library, which loads and works, and no temporary file is left."""
    import concurrent.futures
    import ctypes
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with concurrent.futures.ThreadPoolExecutor(9) as ex:
        paths = [f.result(timeout=300) for f in
                 [ex.submit(native.build) for _ in range(9)]]
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert native._Lib(paths[0]).hex_encode(b"\x0f\xa0") == "0fa0"
    assert isinstance(native._Lib(paths[0])._c, ctypes.CDLL)
