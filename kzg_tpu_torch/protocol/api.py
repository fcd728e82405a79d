"""Public KZG protocol API (counterpart of kzg_tpu/protocol/api.py).

The reference's class surface: init(), blob (from_string / from_bytes),
poly (from_blob, serialize), commit, proof, trusted_setup (generate / load /
create_commit / verify_commit / create_proof x2 / verify_proof /
export_setup), with the same argument validation and error semantics
(ValueError for invalid_argument, RuntimeError for runtime_error).

All heavy math runs on the device chosen at init() — the card unless the
caller asks for the CPU: subproduct-tree interpolation, the MSMs and the
pairing check, with Field.mul (K1) and the G1 add and doubling kernels
(K2, K3) under them. Setup points and polynomial coefficients stay on the
device; only affine results and the verify bit come back to the host.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..context import CurveContext, get_context
from ..ops.poly import PolyEngine
from ..pairing.engine import PairingEngine
from ..refmodel.model import G1 as OracleG1, G2 as OracleG2
from . import serial

# module state (mirrors kzg::init / kzg::CURVE_ORDER_BYTES)
_state = {"ctx": None}

CURVE_ORDER_BYTES = None
MAX_CHUNK_BYTES = None


def init(curve: str = "BN254", device=None):
    """Initialize the library for a curve (must be called first). `device`
    defaults to the CUDA card and raises when there is none; pass
    device="cpu" to run the plain PyTorch versions of the kernels."""
    global CURVE_ORDER_BYTES, MAX_CHUNK_BYTES
    ctx = get_context(curve, device)
    _state["ctx"] = _ProtocolContext(ctx)
    CURVE_ORDER_BYTES = ctx.cp.order_bytes
    MAX_CHUNK_BYTES = ctx.cp.max_chunk_bytes
    return _state["ctx"]


def _ctx() -> "_ProtocolContext":
    if _state["ctx"] is None:
        raise RuntimeError("call kzg_tpu_torch.init() first")
    return _state["ctx"]


class _ProtocolContext:
    """Per-curve state shared by all protocol objects."""

    def __init__(self, ctx: CurveContext):
        self.ctx = ctx
        self.cp = ctx.cp
        self.device = ctx.device
        self.poly = PolyEngine(ctx.fr, ctx.cp)
        self.pairing = None          # built lazily (heavy constants)
        self.og1 = OracleG1(ctx.cp)
        self.og2 = OracleG2(ctx.cp)
        self._g1_table = None
        self._g2_table = None
        self._comb = None

    def pairing_engine(self):
        if self.pairing is None:
            self.pairing = PairingEngine(self.ctx)
        return self.pairing

    # -- generator tables for setup generation -------------------------
    def gen_tables(self):
        """2^j G for j < 8*W (oracle doublings), leading table axis."""
        if self._g1_table is None:
            nb = self.cp.r.bit_length()
            # the comb windows index bits 8w .. 8w+7; the doubling chain
            # must cover bit 8*(W-1)+7 even when nb % 8 != 0
            nbt = 8 * ((nb + 7) // 8)
            og1, og2 = self.og1, self.og2
            t1, t2 = [], []
            P1, P2 = og1.gen, og2.gen
            for _ in range(nbt):
                t1.append(P1)
                t2.append(P2)
                P1 = og1.add(P1, P1)
                P2 = og2.add(P2, P2)
            e1 = self.ctx.g1.encode_points(t1)
            e2 = self.ctx.g2.encode_points(t2)
            self._g1_table = {k: torch.movedim(v, -1, 0) for k, v in e1.items()}
            self._g2_table = {k: torch.movedim(v, -1, 0) for k, v in e2.items()}
        return self._g1_table, self._g2_table

    def comb_tables(self):
        """Fixed-base comb tables [w, d] = d * 2^(8w) * gen for G1/G2, built
        once per curve context."""
        if self._comb is None:
            t1, t2 = self.gen_tables()
            W = (self.cp.r.bit_length() + 7) // 8
            self._comb = (self.ctx.g1.window_table(t1, W),
                          self.ctx.g2.window_table(t2, W))
        return self._comb

    def fr_raw(self, x_mont):
        """Montgomery tensor -> canonical raw limbs (device)."""
        F = self.ctx.fr
        return F.canon(F.from_mont(x_mont))


# --------------------------------------------------------------------------
# blob (reference src/blob.cpp)
# --------------------------------------------------------------------------

class blob:
    """Vector of (x, y) evaluation points encoding data
    (x = chunk index + offset, y = packed chunk scalar)."""

    def __init__(self, data):
        self.data = list(data)

    def get_data(self):
        return self.data

    @staticmethod
    def from_string(s, offset: int = 0) -> "blob":
        if isinstance(s, str):
            s = s.encode("latin-1")
        return blob([(offset + i, c) for i, c in enumerate(s)])

    @staticmethod
    def from_bytes(data: bytes, byte_offset: int, byte_length: int,
                   chunk_size: int) -> "blob":
        pc = _ctx()
        if chunk_size > pc.cp.max_chunk_bytes:
            raise ValueError("chunk_size must be at most MAX_CHUNK_BYTES.")
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive.")
        if byte_offset % chunk_size != 0:
            raise ValueError("byte_offset is not a multiple of chunk_size.")
        if byte_length % chunk_size != 0:
            raise ValueError("byte_length is not a multiple of chunk_size.")
        chunk_offset = byte_offset // chunk_size
        chunk_length = byte_length // chunk_size
        # reference quirk kept: data is read from the START of the buffer;
        # byte_offset shifts only the x-coordinates
        ys = serial.pack_chunks(data, chunk_length, chunk_size)
        return blob([(chunk_offset + i, y) for i, y in enumerate(ys)])

    def _consecutive_offset(self):
        xs = [x for x, _ in self.data]
        off = xs[0]
        if any(x != off + i for i, x in enumerate(xs)):
            raise ValueError("blob x-coordinates must be consecutive")
        return off


# --------------------------------------------------------------------------
# poly (reference src/poly.cpp)
# --------------------------------------------------------------------------

class poly:
    def __init__(self, coeffs):
        """coeffs: canonical int list (normalized — no leading zeros)."""
        self._coeffs = serial.normalize_coeffs(coeffs)
        self._dev = None
        self._n = len(self._coeffs)

    @classmethod
    def _from_device(cls, dev) -> "poly":
        """Wrap device-resident Montgomery coefficients (L, n); ints are
        materialized lazily only for get_poly()/serialize()."""
        self = cls.__new__(cls)
        self._coeffs = None
        self._dev = dev
        self._n = int(dev.shape[-1])
        return self

    @property
    def coeffs(self):
        if self._coeffs is None:
            self._coeffs = serial.normalize_coeffs(
                _ctx().poly.decode(self._dev))
        return self._coeffs

    def get_poly(self):
        return self.coeffs

    @property
    def degree(self):
        return len(self.coeffs) - 1

    def device_coeffs(self, pc: "_ProtocolContext"):
        if self._dev is None:
            self._dev = pc.poly.encode(self._coeffs or [0])
        return self._dev

    @staticmethod
    def from_blob(b: blob) -> "poly":
        pc = _ctx()
        pts = b.get_data()
        if not pts:
            return poly([])
        off = b._consecutive_offset()
        ys = pc.poly.encode([y for _, y in pts])
        off_m = pc.ctx.fr.encode([off])[..., 0]
        return poly._from_device(pc.poly.interpolate(off_m, ys))

    def serialize(self) -> bytes:
        return serial.serialize_poly(self.coeffs)

    @staticmethod
    def deserialize(data: bytes) -> "poly":
        return poly(serial.deserialize_poly(data))


# --------------------------------------------------------------------------
# commit / proof (reference src/commit.cpp, src/proof.cpp)
# --------------------------------------------------------------------------

class _PointWrapper:
    def __init__(self, point):
        self.curve_point = point          # affine (x, y) ints or None

    def get_curve_point(self):
        return self.curve_point

    def serialize(self) -> bytes:
        return serial.serialize_g1(self.curve_point, _ctx().cp)

    @classmethod
    def deserialize(cls, data: bytes):
        return cls(serial.deserialize_g1(bytes(data), _ctx().cp))

    def __eq__(self, other):
        return isinstance(other, _PointWrapper) and \
            self.curve_point == other.curve_point


class commit(_PointWrapper):
    pass


class proof(_PointWrapper):
    pass


# --------------------------------------------------------------------------
# trusted_setup (reference src/trusted_setup.cpp)
# --------------------------------------------------------------------------

class SetupSelfCheckError(RuntimeError):
    """Generated setup disagrees with the exact python oracle at a probe
    index."""


class trusted_setup:
    def __init__(self, arg):
        pc = _ctx()
        self._pc = pc
        self._init_caches()
        if isinstance(arg, str):
            self._g1_host, self._g2_host = serial.read_setup_file(arg, pc.cp)
            self._n = len(self._g1_host)
            return
        num_coeff = int(arg)
        if num_coeff < 2:
            raise ValueError("num_coeff must be at least 2")
        self._generate(secrets.randbelow(pc.cp.r), num_coeff)

    def _init_caches(self):
        self._shift1 = None          # cached shifted G1 bases (device)
        self._shift2 = None          # cached shifted G2 bases (verify)
        self._g1_dev = None          # projective device points
        self._g2_dev = None
        self._g1_host = None         # affine int lists (lazy: export/tests)
        self._g2_host = None

    @classmethod
    def from_secret(cls, s: int, num_coeff: int) -> "trusted_setup":
        """Deterministic setup from a given secret (tests / ceremonies)."""
        if num_coeff < 2:
            raise ValueError("num_coeff must be at least 2")
        self = cls.__new__(cls)
        self._pc = _ctx()
        self._init_caches()
        self._generate(s % self._pc.cp.r, num_coeff)
        return self

    @classmethod
    def _from_device_points(cls, g1_dev, g2_dev) -> "trusted_setup":
        """Wrap projective setup points already on the device."""
        self = cls.__new__(cls)
        self._pc = _ctx()
        self._init_caches()
        self._g1_dev, self._g2_dev = g1_dev, g2_dev
        self._n = int(g1_dev["x"].shape[-1])
        return self

    # -- lazy host materialization (export_setup / test introspection) --
    @property
    def _g1(self):
        if self._g1_host is None:
            self._g1_host = self._pc.ctx.g1.decode_points(self._g1_dev)
        return self._g1_host

    @property
    def _g2(self):
        if self._g2_host is None:
            self._g2_host = self._pc.ctx.g2.decode_points(self._g2_dev)
        return self._g2_host

    # -- generation: fixed-base comb (one byte-digit gather + log2(32)
    #    batched complete-add levels per group), then an exact oracle
    #    self-check at three probe indices --------------------------------
    def _generate(self, s: int, num_coeff: int):
        r = self._pc.cp.r
        self._n = num_coeff
        powers = []
        acc = 1
        for _ in range(num_coeff):
            powers.append(acc)
            acc = acc * s % r
        nbytes = (r.bit_length() + 7) // 8
        buf = b"".join(v.to_bytes(nbytes, "little") for v in powers)
        byte_mat = np.frombuffer(buf, np.uint8).reshape(num_coeff, nbytes)
        self._gen_comb(byte_mat)
        self._check_setup(s, num_coeff)

    @staticmethod
    def _chk_idx(num_coeff):
        return [0, 1, num_coeff - 1]

    def _gen_comb(self, byte_mat):
        pc = self._pc
        digits = torch.from_numpy(byte_mat.T.astype(np.int64)).to(pc.device)
        wt1, wt2 = pc.comb_tables()
        self._g1_dev = pc.ctx.g1.mul_digits_table(digits, wt1)
        self._g2_dev = pc.ctx.g2.mul_digits_table(digits, wt2)

    def _check_setup(self, s: int, num_coeff: int):
        pc = self._pc
        r = pc.cp.r
        idx = self._chk_idx(num_coeff)
        it = torch.tensor(idx, device=pc.device)
        chk1 = pc.ctx.g1.decode_points(
            {k: v[..., it] for k, v in self._g1_dev.items()})
        chk2 = pc.ctx.g2.decode_points(
            {k: v[..., it] for k, v in self._g2_dev.items()})
        for j, i in enumerate(idx):
            e = pow(s, i, r)
            if chk1[j] != pc.og1.mul(e, pc.og1.gen) or \
               chk2[j] != pc.og2.mul(e, pc.og2.gen):
                raise SetupSelfCheckError(
                    "trusted_setup generation self-check failed at index "
                    f"{i} (n={num_coeff}): the generated point disagrees "
                    "with the exact oracle")

    # -- device caches ---------------------------------------------------
    def _g1_points_dev(self):
        if self._g1_dev is None:
            self._g1_dev = self._pc.ctx.g1.encode_points(self._g1_host)
        return self._g1_dev

    def _g2_points_dev(self):
        if self._g2_dev is None:
            self._g2_dev = self._pc.ctx.g2.encode_points(self._g2_host)
        return self._g2_dev

    def _shifted1(self):
        if self._shift1 is None:
            self._shift1 = self._pc.ctx.msm_g1.precompute_shifted(
                self._g1_points_dev())
        return self._shift1

    def _shifted2(self):
        """Window-shifted G2 setup bases (built lazily on first verify)."""
        if self._shift2 is None:
            self._shift2 = self._pc.ctx.msm_g2.precompute_shifted(
                self._g2_points_dev())
        return self._shift2

    def _msm_g1_dev(self, dev, n):
        """MSM of device-resident Montgomery coefficients (L, n) against the
        first n setup points -> affine point."""
        pc = self._pc
        sraw = pc.fr_raw(dev)
        sl = {k: v[..., :n] for k, v in self._shifted1().items()}
        out = pc.ctx.msm_g1.msm_shifted(sraw, sl)
        return pc.ctx.g1.decode_points(out)[0]

    # -- commit ----------------------------------------------------------
    def create_commit(self, p: poly) -> commit:
        nmax = self._n
        if p._dev is not None and 0 < p._n < nmax:
            # allocated length fits the setup: zero top coefficients cannot
            # change the MSM result or trip the degree guard
            return commit(self._msm_g1_dev(p.device_coeffs(self._pc), p._n))
        if p.degree + 1 >= nmax:
            raise ValueError("polynomial degree must be at most one less "
                             "than the setup size (num_coeffs)")
        if len(p.coeffs) == 0:
            return commit(None)
        n = len(p.coeffs)                      # true length (top zeros cut)
        return commit(self._msm_g1_dev(p.device_coeffs(self._pc)[..., :n], n))

    def verify_commit(self, c: commit, p: poly) -> bool:
        return self.create_commit(p).curve_point == c.curve_point

    # -- proofs ----------------------------------------------------------
    def create_proof(self, p: poly, a, b, chunk_size=None) -> proof:
        if chunk_size is not None:
            byte_offset, byte_length = a, b
            if chunk_size > self._pc.cp.max_chunk_bytes:
                raise ValueError(
                    "chunk_size must be at most MAX_CHUNK_BYTES.")
            if byte_offset % chunk_size != 0:
                raise ValueError("byte_offset is not a multiple of chunk_size.")
            if byte_length % chunk_size != 0:
                raise ValueError("byte_length is not a multiple of chunk_size.")
            return self.create_proof(p, byte_offset // chunk_size,
                                     byte_length // chunk_size)
        chunk_offset, chunk_length = a, b
        if chunk_length < 1:
            raise ValueError("chunk_length must be 1 or greater")
        pc = self._pc
        pe = pc.poly
        n = max(p._n, chunk_length + 1)        # device length; no decode
        Pd = pe._pad_last(p.device_coeffs(pc), n)
        om = pc.ctx.fr.encode([chunk_offset])[..., 0]
        ys = pe.multieval(Pd, om, chunk_length)
        I = pe.interpolate(om, ys)
        Z = pe.vanishing(om, chunk_length)
        q = pe.quotient(Pd, I, Z)
        return proof(self._msm_g1_dev(q, n - chunk_length))

    def verify_proof(self, c: commit, pr: proof, expected_data: blob) -> bool:
        pc = self._pc
        points = expected_data.get_data()
        if len(points) < 1:
            raise ValueError("expected_data size must be 1 or greater")
        if len(points) >= self._n:
            return False
        off = expected_data._consecutive_offset()
        k = len(points)
        fr = pc.ctx.fr
        pe = pc.poly
        g1c = pc.ctx.g1
        ysd = fr.encode([y for _, y in points])
        om = fr.encode([off])[..., 0]
        cm0 = self._g1_point_dev(c.curve_point)
        pr0 = self._g1_point_dev(pr.curve_point)
        I = pe.interpolate(om, ysd)
        Z = pe.vanishing(om, k)
        g1s = {kk: v[..., :k] for kk, v in self._shifted1().items()}
        g2s = {kk: v[..., :k + 1] for kk, v in self._shifted2().items()}
        zc = pc.ctx.msm_g2.msm_shifted(pc.fr_raw(Z), g2s)
        ic = pc.ctx.msm_g1.msm_shifted(pc.fr_raw(I), g1s)
        p2 = g1c.add(g1c.neg(ic), cm0)
        ok = pc.pairing_engine().pairing_check(zc, pr0, self._g2gen(), p2)
        return bool(ok.item())

    def _g2gen(self):
        return self._pc.pairing_engine()._gen2()

    def _g1_point_dev(self, point):
        """Affine int point (or None) -> projective point, batch ()."""
        P = self._pc.ctx.g1.encode_points([point])
        return {k: v[..., 0] for k, v in P.items()}

    # -- persistence -----------------------------------------------------
    def export_setup(self, filename: str = "kzg_public"):
        serial.write_setup_file(filename, self._g1, self._g2, self._pc.cp)
