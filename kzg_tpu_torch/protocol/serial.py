"""Byte-level codecs of the reference wire formats (pure python; counterpart
of kzg_tpu/protocol/serial.py without its optional native helper).

Formats:
  * G1 point   — u32-LE length + uncompressed octet 0x04||X||Y, X/Y
                 big-endian MODBYTES each; a failed deserialize yields the
                 point at infinity;
  * G2 point   — u32-LE length + 0x04||x.re||x.im||y.re||y.im;
  * polynomial — i64-LE degree, then per coefficient u8 byte-count + that
                 many little-endian bytes, leading zeros stripped; degree -1
                 encodes the zero polynomial;
  * trusted setup file — u64-LE count, count G1 records, count G2 records.

The point at infinity serializes with all-zero coordinates; (0, 0) is never
on y^2 = x^3 + b for our curves (b != 0), so the on-curve check routes it
back to infinity on load.
"""

from __future__ import annotations

import struct

from ..curves.params import CurveParams
from ..refmodel.model import G2 as OracleG2


# ----------------------------------------------------------------------------
# G1 points
# ----------------------------------------------------------------------------

def g1_octet(point, modbytes: int) -> bytes:
    """Affine point (x, y) or None -> 0x04||X||Y (big-endian)."""
    if point is None:
        x = y = 0
    else:
        x, y = point
    return b"\x04" + int(x).to_bytes(modbytes, "big") + \
        int(y).to_bytes(modbytes, "big")


def g1_from_octet(data: bytes, cp: CurveParams):
    """Octet -> point; invalid encodings -> infinity (soft-fail)."""
    modbytes = cp.modbytes
    if len(data) != 2 * modbytes + 1 or data[0] != 0x04:
        return None
    x = int.from_bytes(data[1:1 + modbytes], "big")
    y = int.from_bytes(data[1 + modbytes:], "big")
    if x >= cp.p or y >= cp.p:
        return None
    if (y * y - x * x * x - cp.b) % cp.p != 0:
        return None
    return (x, y)


def serialize_g1(point, cp: CurveParams) -> bytes:
    oct_ = g1_octet(point, cp.modbytes)
    return struct.pack("<I", len(oct_)) + oct_


def deserialize_g1(data: bytes, cp: CurveParams):
    (ln,) = struct.unpack_from("<I", data, 0)
    return g1_from_octet(data[4:4 + ln], cp)


# ----------------------------------------------------------------------------
# G2 points
# ----------------------------------------------------------------------------

def g2_octet(point, modbytes: int) -> bytes:
    if point is None:
        parts = (0, 0, 0, 0)
    else:
        (x0, x1), (y0, y1) = point
        parts = (x0, x1, y0, y1)
    return b"\x04" + b"".join(int(c).to_bytes(modbytes, "big")
                              for c in parts)


def g2_from_octet(data: bytes, cp: CurveParams, og2=None):
    modbytes = cp.modbytes
    if len(data) != 4 * modbytes + 1 or data[0] != 0x04:
        return None
    cs = [int.from_bytes(data[1 + i * modbytes:1 + (i + 1) * modbytes], "big")
          for i in range(4)]
    if any(c >= cp.p for c in cs):
        return None
    pt = ((cs[0], cs[1]), (cs[2], cs[3]))
    if not (og2 or OracleG2(cp)).is_on(pt):
        return None
    return pt


def serialize_g2(point, cp: CurveParams) -> bytes:
    oct_ = g2_octet(point, cp.modbytes)
    return struct.pack("<I", len(oct_)) + oct_


# ----------------------------------------------------------------------------
# polynomials (coefficient lists of canonical ints mod r)
# ----------------------------------------------------------------------------

def normalize_coeffs(coeffs):
    c = list(coeffs)
    while c and c[-1] == 0:
        c.pop()
    return c


def serialize_poly(coeffs) -> bytes:
    c = normalize_coeffs(coeffs)
    out = [struct.pack("<q", len(c) - 1)]
    for v in c:
        v = int(v)
        nb = (v.bit_length() + 7) // 8
        out.append(struct.pack("<B", nb))
        if nb:
            out.append(v.to_bytes(nb, "little"))
    return b"".join(out)


def deserialize_poly(data: bytes):
    (deg,) = struct.unpack_from("<q", data, 0)
    off = 8
    coeffs = []
    for _ in range(max(0, deg + 1)):
        nb = data[off]
        off += 1
        coeffs.append(int.from_bytes(data[off:off + nb], "little"))
        off += nb
    return normalize_coeffs(coeffs)


# ----------------------------------------------------------------------------
# trusted setup file (byte-compatible `kzg_public`)
# ----------------------------------------------------------------------------

def write_setup_file(path: str, g1_pts, g2_pts, cp: CurveParams):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(g1_pts)))
        for p in g1_pts:
            f.write(serialize_g1(p, cp))
        for p in g2_pts:
            f.write(serialize_g2(p, cp))


def read_setup_file(path: str, cp: CurveParams):
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise RuntimeError("could not open trusted setup file") from e
    og2 = OracleG2(cp)
    try:
        (count,) = struct.unpack_from("<Q", data, 0)
        off = 8
        g1, g2 = [], []
        for _ in range(count):
            (ln,) = struct.unpack_from("<I", data, off)
            off += 4
            pt = g1_from_octet(data[off:off + ln], cp)
            if pt is None:
                raise RuntimeError("bad trusted setup file")
            g1.append(pt)
            off += ln
        for _ in range(count):
            (ln,) = struct.unpack_from("<I", data, off)
            off += 4
            pt = g2_from_octet(data[off:off + ln], cp, og2)
            if pt is None:
                raise RuntimeError("bad trusted setup file")
            g2.append(pt)
            off += ln
    except (struct.error, IndexError) as e:
        raise RuntimeError("bad trusted setup file") from e
    return g1, g2


# ----------------------------------------------------------------------------
# blob byte packing (reference blob.cpp semantics)
# ----------------------------------------------------------------------------

def pack_chunks(data: bytes, chunk_length: int, chunk_size: int) -> list:
    """First chunk_length*chunk_size bytes of `data`, chunk_size bytes per
    scalar, little-endian. Data is always read from the START of the buffer
    — the caller pre-offsets (reference quirk)."""
    return [int.from_bytes(data[i * chunk_size:(i + 1) * chunk_size], "little")
            for i in range(chunk_length)]
