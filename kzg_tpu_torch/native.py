"""ctypes bindings for the port's native codec library
(csrc/kzg_native.cpp; counterpart of kzg_tpu/native.py).

The library is host C++: hex codecs, blob chunk packing into the limb-major
(n_limbs, n) matrix that ``Field`` tensors upload, big-endian records <->
limb matrices and the polynomial stream codec. ``lib()`` compiles it at
first use with the host's C++ compiler (``$CXX``, else ``c++``) into
``build/kzg_tpu_torch/libkzg_native_<hash>.so`` at the root of the checkout
(the hash covers the source, the compiler and the flags, so a stale library
is never loaded) and loads it; importing this module builds nothing. There
is no fallback: a missing compiler or a failed build raises RuntimeError
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .fields.mont import limbs_to_ints

SOURCE = Path(__file__).resolve().parent / "csrc" / "kzg_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kzg_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]

_lock = threading.Lock()
_lib = None


def _compiler():
    cmd = shlex.split(os.environ.get("CXX") or "c++")
    path = shutil.which(cmd[0]) if cmd else None
    if path is None:
        raise RuntimeError(f"C++ compiler not found: {cmd!r} (set CXX); "
                           "the native codec library builds with it")
    return [path, *cmd[1:]]


def _so_path(cxx):
    h = hashlib.sha256(" ".join(cxx + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libkzg_native_{h.hexdigest()[:16]}.so"


def build():
    """Compile the library unless it is built; returns its path. Each
    process and thread compiles to a file of its own and renames it into
    place, so builds that run at once never load a half-written
    library."""
    cxx = _compiler()
    so = _so_path(cxx)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    out = subprocess.run([*cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({' '.join(cxx)},"
                           f" exit {out.returncode}):\n{out.stdout}"
                           f"{out.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> "_Lib":
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _Lib(build())
        return _lib


def _check_len(have, need):
    if have < need:
        raise ValueError("buffer shorter than requested range")


class _Lib:
    def __init__(self, so):
        self.path = Path(so)
        self._c = ctypes.CDLL(str(so))
        c = self._c
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        c.kzg_hex_decode.restype = ctypes.c_int
        c.kzg_hex_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p]
        c.kzg_hex_encode.restype = None
        c.kzg_hex_encode.argtypes = [u8p, ctypes.c_int64, ctypes.c_char_p]
        c.kzg_pack_chunks_limbs.restype = None
        c.kzg_pack_chunks_limbs.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, u32p]
        c.kzg_be_to_limbs.restype = None
        c.kzg_be_to_limbs.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, u32p]
        c.kzg_limbs_to_be.restype = None
        c.kzg_limbs_to_be.argtypes = [
            u32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, u8p]
        c.kzg_poly_encode.restype = ctypes.c_int64
        c.kzg_poly_encode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32, u8p]
        c.kzg_poly_decode.restype = ctypes.c_int64
        c.kzg_poly_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32, u8p]

    @staticmethod
    def _u8(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    @staticmethod
    def _u32(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))

    def hex_decode(self, s: str) -> bytes:
        n = len(s) // 2
        out = np.empty(n, dtype=np.uint8)
        rc = self._c.kzg_hex_decode(s.encode(), len(s) - len(s) % 2,
                                    self._u8(out))
        if rc != 0:
            raise ValueError("invalid hex")
        return out.tobytes()

    def hex_encode(self, b: bytes) -> str:
        arr = np.frombuffer(bytes(b), dtype=np.uint8)
        out = ctypes.create_string_buffer(2 * len(arr))
        self._c.kzg_hex_encode(self._u8(arr), len(arr), out)
        return out.raw.decode()

    def pack_chunks(self, data: bytes, chunk_length: int,
                    chunk_size: int) -> list:
        """Python ints, one per chunk (the signature of
        protocol.serial.pack_chunks)."""
        _check_len(len(data), chunk_length * chunk_size)
        n_limbs = (chunk_size + 1) // 2
        if n_limbs == 0:
            return [0] * chunk_length
        return limbs_to_ints(self.pack_chunks_limbs(data, chunk_length,
                                                    chunk_size, n_limbs))

    def pack_chunks_limbs(self, data: bytes, chunk_length: int,
                          chunk_size: int, n_limbs: int) -> np.ndarray:
        """Limb-major (n_limbs, chunk_length) uint32 matrix of the chunks,
        the layout a Field tensor uploads without python ints."""
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        _check_len(len(arr), chunk_length * chunk_size)
        out = np.zeros((n_limbs, chunk_length), dtype=np.uint32)
        self._c.kzg_pack_chunks_limbs(self._u8(arr), chunk_length,
                                      chunk_size, n_limbs, self._u32(out))
        return out

    def be_to_limbs(self, recs: bytes, n: int, width: int,
                    n_limbs: int) -> np.ndarray:
        arr = np.frombuffer(bytes(recs), dtype=np.uint8)
        _check_len(len(arr), n * width)
        out = np.zeros((n_limbs, n), dtype=np.uint32)
        self._c.kzg_be_to_limbs(self._u8(arr), n, width, n_limbs,
                                self._u32(out))
        return out

    def limbs_to_be(self, limbs: np.ndarray, width: int) -> bytes:
        limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
        n_limbs, n = limbs.shape
        out = np.zeros(n * width, dtype=np.uint8)
        self._c.kzg_limbs_to_be(self._u32(limbs), n, n_limbs, width,
                                self._u8(out))
        return out.tobytes()

    def poly_encode(self, rows_le: np.ndarray) -> bytes:
        rows_le = np.ascontiguousarray(rows_le, dtype=np.uint8)
        n, width = rows_le.shape
        sz = self._c.kzg_poly_encode(self._u8(rows_le), n, width, None)
        out = np.zeros(int(sz), dtype=np.uint8)
        self._c.kzg_poly_encode(self._u8(rows_le), n, width, self._u8(out))
        return out.tobytes()

    def poly_decode(self, data: bytes, width: int) -> np.ndarray:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        n = self._c.kzg_poly_decode(self._u8(arr), len(arr), width, None)
        if n < 0:
            raise ValueError("malformed polynomial stream")
        out = np.zeros((int(n), width), dtype=np.uint8)
        self._c.kzg_poly_decode(self._u8(arr), len(arr), width,
                                self._u8(out))
        return out
