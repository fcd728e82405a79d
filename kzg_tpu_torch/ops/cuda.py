"""Build, bind and launch layer of the port's hand-written CUDA kernels.

Counterpart of kzg_tpu/ops/fuse.py, the JAX package's one Pallas tiler:
where the tiler traced a pointwise function into one VMEM-resident TPU
kernel, each of its call sites on the main path is here a kernel written by
hand for Hopper (sm_90a):

  K1 ``mont_mul`` (csrc/mont_mul.cu) — Montgomery multiply (T1);
  K2 ``g1_add``   (csrc/g1_ops.cu)   — G1 complete add with reset mask
                                       (T2, T4, T6, T7);
  K3 ``g1_dbl``   (csrc/g1_ops.cu)   — chain of G1 doublings (T3).

Each source compiles at first use with nvcc into a shared library with a
plain C interface under ``build/kzg_tpu_torch/`` at the root of the
checkout (named by a hash of the sources and flags, so a stale library is
never loaded), and is loaded with ctypes. ``build()`` compiles all sources
at once, one nvcc process each.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on torch's current stream, raises if
the launch returned a CUDA error, and adds one to its kernel's ``launches``
count. The plain PyTorch versions the kernels are held against live beside
their callers: ``Field._mul_plain`` (fields/mont.py) and
``Curve._add_plain`` / ``Curve._dbl_plain`` (groups/ec.py).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kzg_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"mont_mul": "mont_mul.cu", "g1_ops": "g1_ops.cu"}
HEADERS = ["mont.cuh"]


class Kernel:
    """Launch counter and provenance of one hand-written kernel."""

    def __init__(self, name, lib, source, replaces):
        self.name = name
        self.lib = lib                 # key of SOURCES
        self.source = source           # path in the repo
        self.replaces = replaces       # the TPU kernel's call site(s)
        self.launches = 0
        self.shapes = collections.Counter()   # lanes (and times) per launch

    def count(self, shape_key):
        self.launches += 1
        self.shapes[shape_key] += 1


KERNELS = {
    "mont_mul": Kernel(
        "mont_mul", "mont_mul", "kzg_tpu_torch/csrc/mont_mul.cu",
        "kzg_tpu/fields/mont.py:340 (T1 Field.mul -> fuse_pointwise, "
        "kzg_tpu/ops/fuse.py:196)"),
    "g1_add": Kernel(
        "g1_add", "g1_ops", "kzg_tpu_torch/csrc/g1_ops.cu",
        "kzg_tpu/groups/ec.py:178 (T2 Curve.add_f); kzg_tpu/ops/msm.py:271 "
        "(T4 chunked step); kzg_tpu/ops/msm.py:512,535 (T6/T7)"),
    "g1_dbl": Kernel(
        "g1_dbl", "g1_ops", "kzg_tpu_torch/csrc/g1_ops.cu",
        "kzg_tpu/groups/ec.py:185 (T3 Curve.dbl_f)"),
}


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0
        k.shapes.clear()


def counts():
    return {name: k.launches for name, k in KERNELS.items()}


# ----------------------------------------------------------------------
# build and load
# ----------------------------------------------------------------------

_lock = threading.Lock()
_libs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    if home:
        cands.append(str(Path(home) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _so_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [SOURCES[name]] + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None):
    """Compile the given sources (default: all) that are not built yet, one
    nvcc process each, all started together. Returns {name: seconds}."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.time()
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, so,
                       log)
    secs = {}
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.time() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, so)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return secs


def build_log(name):
    """nvcc's output (ptxas register and spill report) of the last build."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    "kzg_mont_mul": [_VP, _VP, _VP, _I64, _VP, _INT, _VP],
    "kzg_g1_add": [_VP] * 8 + [_I64, _VP, _INT, _VP],
    "kzg_g1_dbl": [_VP] * 4 + [_I64, _INT, _VP, _INT, _VP],
}


def _lib(name):
    with _lock:
        if name not in _libs:
            so = _so_path(name)
            if not so.exists():
                build([name])
            lib = ctypes.CDLL(str(so))
            for fn, args in _ARGTYPES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {rc}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _require(t, L, what):
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: tensor on {t.device}, kernel needs cuda")
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: dtype {t.dtype}, kernel takes int64 limbs")
    if t.shape[0] != L:
        raise ValueError(f"{what}: leading (limb) axis {t.shape[0]} != {L}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


# ----------------------------------------------------------------------
# host-side constant arrays (kept alive on the field / curve object)
# ----------------------------------------------------------------------

def _u32(vals):
    return (ctypes.c_uint32 * len(vals))(*[int(v) for v in vals])


def _mod_consts(F):
    """p, R mod p, n0 — the layout of mont.cuh mod_from_host."""
    c = getattr(F, "_k1_consts", None)
    if c is None:
        c = _u32(list(F.params.limbs) + list(F.params.one_limbs) + [F.n0])
        F._k1_consts = c
    return c


def _g1_consts(G):
    """K1's constants, then lift16, lift32, 3b as a small integer and 9b in
    Montgomery form — the layout of g1_ops.cu g1_from_host. The kernels
    follow Curve._add_plain / _dbl_plain on the branches those take when
    3b <= 14 (a lazy small multiple) and 9b > 15 (a full product), as for
    BN254; other curves raise."""
    c = getattr(G, "_k23_consts", None)
    if c is None:
        F = G.F
        p = F.modulus
        b3 = G._b3_int
        if not (b3 <= 14 and 3 * b3 > 15):
            raise ValueError(f"{G.name}: K2/K3 take 3b <= 14 and 9b > 15, "
                             f"not 3b = {b3}")
        m9 = 3 * b3 * F.params.mont_r % p
        vals = (list(F.params.limbs) + list(F.params.one_limbs) + [F.n0]
                + F.lift_limbs(16)[0] + F.lift_limbs(32)[0] + [b3]
                + [(m9 >> (16 * i)) & 0xFFFF for i in range(F.L)])
        c = _u32(vals)
        G._k23_consts = c
    return c


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def mont_mul(F, a, b):
    """K1: Montgomery product of two equally shaped (L, *batch) int64 limb
    tensors on the card (a broadcast input is materialized first)."""
    if a.shape != b.shape:
        raise ValueError(f"mont_mul: shapes {tuple(a.shape)} != "
                         f"{tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    _require(a, F.L, "mont_mul")
    _require(b, F.L, "mont_mul")
    if b.device != a.device:
        raise ValueError("mont_mul: operands on different devices")
    out = torch.empty_like(a)
    lanes = a.numel() // F.L
    if lanes == 0:
        return out
    lib = _lib("mont_mul")
    _check(lib.kzg_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            lanes, ctypes.cast(_mod_consts(F), _VP), F.L,
                            _stream()), "mont_mul")
    KERNELS["mont_mul"].count(lanes)
    return out


def _coords(P, L, what):
    out = []
    for k in ("x", "y", "z"):
        t = P[k].contiguous()
        _require(t, L, what)
        out.append(t)
    return out


def _unpack(out, batch):
    return {k: out[i].reshape((out.shape[1],) + batch)
            for i, k in enumerate(("x", "y", "z"))}


def g1_add(G, P, Q, reset=None):
    """K2: out = reset ? Q : P + Q per lane (complete add), G1 point dicts
    of (L, *batch) int64 coordinates on the card; reset is a bool tensor of
    the batch shape or None."""
    L = G.F.L
    xs = torch.broadcast_tensors(P["x"], P["y"], P["z"],
                                 Q["x"], Q["y"], Q["z"])
    batch = tuple(xs[0].shape[1:])
    Pc = _coords(dict(zip("xyz", xs[:3])), L, "g1_add")
    Qc = _coords(dict(zip("xyz", xs[3:])), L, "g1_add")
    lanes = Pc[0].numel() // L
    out = torch.empty((3, L, lanes), dtype=torch.int64, device=Pc[0].device)
    if lanes == 0:
        return _unpack(out, batch)
    rptr = None
    if reset is not None:
        reset = torch.as_tensor(reset, device=Pc[0].device)
        if reset.dtype != torch.bool:
            raise TypeError("g1_add: reset mask must be bool")
        reset = reset.expand(batch).contiguous().view(torch.uint8)
        rptr = reset.data_ptr()
    lib = _lib("g1_ops")
    _check(lib.kzg_g1_add(*[t.data_ptr() for t in Pc + Qc], rptr,
                          out.data_ptr(), lanes,
                          ctypes.cast(_g1_consts(G), _VP), L, _stream()),
           "g1_add")
    KERNELS["g1_add"].count(lanes)
    return _unpack(out, batch)


def g1_dbl(G, P, times):
    """K3: 2^times P per lane, G1 point dict on the card."""
    L = G.F.L
    if times < 1:
        raise ValueError("g1_dbl: times must be >= 1")
    xs = torch.broadcast_tensors(P["x"], P["y"], P["z"])
    batch = tuple(xs[0].shape[1:])
    Pc = _coords(dict(zip("xyz", xs)), L, "g1_dbl")
    lanes = Pc[0].numel() // L
    out = torch.empty((3, L, lanes), dtype=torch.int64, device=Pc[0].device)
    if lanes == 0:
        return _unpack(out, batch)
    lib = _lib("g1_ops")
    _check(lib.kzg_g1_dbl(*[t.data_ptr() for t in Pc], out.data_ptr(),
                          lanes, int(times), ctypes.cast(_g1_consts(G), _VP),
                          L, _stream()), "g1_dbl")
    KERNELS["g1_dbl"].count((lanes, int(times)))
    return _unpack(out, batch)
