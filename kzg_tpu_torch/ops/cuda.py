"""Build, bind and launch layer of the port's hand-written CUDA kernels.

Counterpart of kzg_tpu/ops/fuse.py, the JAX package's one Pallas tiler:
where the tiler traced a pointwise function into one VMEM-resident TPU
kernel, each of its call sites is here a kernel written by hand for Hopper
(sm_90a):

  K1 ``mont_mul``         (csrc/mont_mul.cu)  — Montgomery multiply (T1);
  K2 ``g1_add``           (csrc/g1_ops.cu)    — G1 complete add with reset
                                                mask (T2, T4, T6, T7);
  K3 ``g1_dbl``           (csrc/g1_ops.cu)    — chain of G1 doublings (T3);
  K4 ``g2_add``           (csrc/g2_ops.cu)    — G2 complete add with reset
                                                mask (T2, T4, T6, T7);
  K5 ``g2_dbl``           (csrc/g2_ops.cu)    — chain of G2 doublings (T3);
  K6 ``merge_combine_g1`` / ``merge_combine_g2`` (csrc/msm_merge.cu) — the
                          merge strategy's per-level combine (T5).

K2-K6 run lane teams (csrc/team.cuh) over the constant rows and schedule
table of ops/team.py (K6 runs the add's schedule, in a layout of its own
from team.MERGE_WIDE lanes up). A group's constant array is K1's modulus
words (p, R mod p, n0: 2 L + 1 uint32 of the base field), then that team
block (_g1_consts, _g2_consts).

Each source compiles at first use with nvcc into a shared library with a
plain C interface under ``build/kzg_tpu_torch/`` at the root of the
checkout (named by a hash of the sources and flags, so a stale library is
never loaded), and is loaded with ctypes. ``build()`` compiles all sources
at once, one nvcc process each.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on torch's current stream, raises if
the launch returned a CUDA error, and adds one to its kernel's ``launches``
count. K6 reads its inputs in place where each one's batch axes flatten
to one lane stride (the stride-2 halves of a merge level's sums) and
copies the others. The plain PyTorch versions the kernels are held
against live beside their callers: ``Field._mul_plain``
(fields/mont.py), ``Curve._add_plain`` / ``Curve._dbl_plain``
(groups/ec.py, G1 and G2) and ``MSMEngine._combine_plain``
(ops/msm.py).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import team

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kzg_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"mont_mul": "mont_mul.cu", "g1_ops": "g1_ops.cu",
           "g2_ops": "g2_ops.cu", "msm_merge": "msm_merge.cu"}
HEADERS = ["mont.cuh", "team.cuh"]


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
    "g2_add": Kernel(
        "g2_add", "g2_ops", "kzg_tpu_torch/csrc/g2_ops.cu",
        "kzg_tpu/groups/ec.py:178 (T2 Curve.add_f, G2); kzg_tpu/ops/msm.py:"
        "271 (T4 chunked step); kzg_tpu/ops/msm.py:512,535 (T6/T7)"),
    "g2_dbl": Kernel(
        "g2_dbl", "g2_ops", "kzg_tpu_torch/csrc/g2_ops.cu",
        "kzg_tpu/groups/ec.py:185 (T3 Curve.dbl_f, G2)"),
    "merge_combine_g1": Kernel(
        "merge_combine_g1", "msm_merge", "kzg_tpu_torch/csrc/msm_merge.cu",
        "kzg_tpu/ops/msm.py:187 (T5 merge combine, G1)"),
    "merge_combine_g2": Kernel(
        "merge_combine_g2", "msm_merge", "kzg_tpu_torch/csrc/msm_merge.cu",
        "kzg_tpu/ops/msm.py:187 (T5 merge combine, G2)"),
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
    while len(secs) < len(procs):          # each source's own finish time
        for name, (proc, tmp, so, log) in procs.items():
            if name in secs or proc.poll() is None:
                continue
            log.close()
            secs[name] = time.time() - t0
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, so)
        time.sleep(0.1)
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
    "kzg_g2_add": [_VP] * 8 + [_I64, _VP, _INT, _VP],
    "kzg_g2_dbl": [_VP] * 4 + [_I64, _INT, _VP, _INT, _VP],
    "kzg_merge_combine_g1": [_VP] * 3 + [_I64, _VP, _INT, _VP],
    "kzg_merge_combine_g2": [_VP] * 3 + [_I64, _VP, _INT, _VP],
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


def _require(t, lead, what, contiguous=True):
    """A kernel operand: int64, on the card, with the leading (component
    and limb) axes `lead`, and contiguous unless the kernel takes
    strides."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: tensor on {t.device}, kernel needs cuda")
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: dtype {t.dtype}, kernel takes int64 limbs")
    if tuple(t.shape[:len(lead)]) != tuple(lead):
        raise ValueError(f"{what}: leading (limb) axes "
                         f"{tuple(t.shape[:len(lead)])} != {tuple(lead)}")
    if contiguous and not t.is_contiguous():
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
    """K1's constants, then the lane-team block of K2/K3/K6 (team.block).
    The schedules follow Curve._add_plain / _dbl_plain on the branches
    those take when 3b <= 14 (a lazy small multiple) and 9b > 15 (a full
    product), as for BN254; other curves raise."""
    F = G.F
    b3 = G._b3_int
    if not (b3 <= 14 and 3 * b3 > 15):
        raise ValueError(f"{G.name}: the G1 kernels take 3b <= 14 and "
                         f"9b > 15, not 3b = {b3}")
    return (list(F.params.limbs) + list(F.params.one_limbs) + [F.n0]
            + team.block(G))


def _g2_consts(G):
    """K1's constants of the base field, then the lane-team block of
    K4/K5/K6 (team.block). The schedules take Fp2 with qnr = -1, as
    BN254's; other curves raise."""
    F2 = G.F
    B = F2.base
    if not F2.qnr_is_m1:
        raise ValueError(f"{G.name}: the G2 kernels take qnr = -1")
    return (list(B.params.limbs) + list(B.params.one_limbs) + [B.n0]
            + team.block(G))


def _consts(G):
    """The constant block of G's point kernels, built once per curve."""
    c = getattr(G, "_kernel_consts", None)
    if c is None:
        c = _u32(_g2_consts(G) if G.is_fp2 else _g1_consts(G))
        G._kernel_consts = c
    return ctypes.cast(c, _VP)


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
    _require(a, (F.L,), "mont_mul")
    _require(b, (F.L,), "mont_mul")
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


def _lead(G):
    """Leading axes of one coordinate of G: (L,) for G1, (2, L) for G2."""
    return (2, G.F.base.L) if G.is_fp2 else (G.F.L,)


def _broadcast(t, n, batch):
    """t (n leading axes, then batch axes) broadcast to `batch` the way the
    field ops broadcast (batch axes after the limb axes), contiguous."""
    t = t.reshape(t.shape[:n] + (1,) * (len(batch) + n - t.ndim)
                  + t.shape[n:])
    return t.expand(t.shape[:n] + batch).contiguous()


def _points(G, pts, what):
    """The x, y, z coordinates of the point dicts `pts`, broadcast over one
    batch shape, contiguous and checked. Returns (coordinates, batch,
    lanes)."""
    lead = _lead(G)
    n = len(lead)
    coords = [P[k] for P in pts for k in ("x", "y", "z")]
    batch = tuple(torch.broadcast_shapes(*[t.shape[n:] for t in coords]))
    out = []
    for t in coords:
        t = _broadcast(t, n, batch)
        _require(t, lead, what)
        out.append(t)
    return out, batch, math.prod(batch)


def _mask(m, batch, dev, what):
    """A bool mask of the batch shape as contiguous uint8 on the card."""
    m = torch.as_tensor(m, device=dev)
    if m.dtype != torch.bool:
        raise TypeError(f"{what}: masks must be bool, not {m.dtype}")
    return m.expand(batch).contiguous().view(torch.uint8)


def _lane_stride(shape, strides):
    """The one stride that steps a lane through batch axes `shape` (with
    `strides`) flattened in order, or None where they do not flatten to
    one."""
    lane = step = None
    for n, s in zip(reversed(shape), reversed(strides)):
        if n == 1:
            continue
        if lane is None:
            lane = s
        elif s != step:
            return None
        step = s * n
    return 1 if lane is None else lane


def _in_place(t, n, batch):
    """An operand of K6 with n leading axes: t itself where its batch axes
    are `batch` and flatten to one lane stride, else a contiguous copy
    broadcast to `batch`; and its lane stride."""
    lane = (_lane_stride(t.shape[n:], t.stride()[n:])
            if tuple(t.shape[n:]) == batch else None)
    if lane is None:
        return _broadcast(t, n, batch), 1
    return t, lane


def _unpack(out, batch):
    """(3, *lead, lanes) kernel output -> point dict of (*lead, *batch)."""
    return {k: out[i].reshape(out.shape[1:-1] + batch)
            for i, k in enumerate(("x", "y", "z"))}


def _point_add(name, G, P, Q, reset):
    c, batch, lanes = _points(G, (P, Q), name)
    dev = c[0].device
    out = torch.empty((3,) + _lead(G) + (lanes,), dtype=torch.int64,
                      device=dev)
    if lanes == 0:
        return _unpack(out, batch)
    rptr = None
    if reset is not None:
        reset = _mask(reset, batch, dev, name)
        rptr = reset.data_ptr()
    kern = KERNELS[name]
    fn = getattr(_lib(kern.lib), "kzg_" + name)
    _check(fn(*[t.data_ptr() for t in c], rptr, out.data_ptr(), lanes,
              _consts(G), _lead(G)[-1], _stream()), name)
    kern.count(lanes)
    return _unpack(out, batch)


def _point_dbl(name, G, P, times):
    if times < 1:
        raise ValueError(f"{name}: times must be >= 1")
    c, batch, lanes = _points(G, (P,), name)
    out = torch.empty((3,) + _lead(G) + (lanes,), dtype=torch.int64,
                      device=c[0].device)
    if lanes == 0:
        return _unpack(out, batch)
    kern = KERNELS[name]
    fn = getattr(_lib(kern.lib), "kzg_" + name)
    _check(fn(*[t.data_ptr() for t in c], out.data_ptr(), lanes, int(times),
              _consts(G), _lead(G)[-1], _stream()), name)
    kern.count((lanes, int(times)))
    return _unpack(out, batch)


def g1_add(G, P, Q, reset=None):
    """K2: out = reset ? Q : P + Q per lane (complete add), G1 point dicts
    of (L, *batch) int64 coordinates on the card; reset is a bool tensor of
    the batch shape or None."""
    return _point_add("g1_add", G, P, Q, reset)


def g1_dbl(G, P, times):
    """K3: 2^times P per lane, G1 point dict on the card."""
    return _point_dbl("g1_dbl", G, P, times)


def g2_add(G, P, Q, reset=None):
    """K4: out = reset ? Q : P + Q per lane (complete add), G2 point dicts
    of (2, L, *batch) int64 coordinates on the card; reset is a bool tensor
    of the batch shape or None."""
    return _point_add("g2_add", G, P, Q, reset)


def g2_dbl(G, P, times):
    """K5: 2^times P per lane, G2 point dict on the card."""
    return _point_dbl("g2_dbl", G, P, times)


def merge_combine(G, aL, aR, bL, bR, fuse, asing, bsing):
    """K6 (G1 or G2 instance by the curve): one merge level's combine,
    mid = aR + bL, newL = (asing & fuse) ? mid : aL, newR = (bsing & fuse)
    ? mid : bR per lane. Point dicts and bool masks on the card over one
    batch; returns (mid, newL, newR). Inputs whose batch axes flatten to
    one lane stride (a merge level's stride-2 halves) are read in place."""
    name = "merge_combine_g2" if G.is_fp2 else "merge_combine_g1"
    lead = _lead(G)
    n = len(lead)
    coords = [P[k] for P in (aL, aR, bL, bR) for k in ("x", "y", "z")]
    batch = tuple(torch.broadcast_shapes(*[t.shape[n:] for t in coords]))
    lanes = math.prod(batch)
    ops, strides = [], []
    for t in coords:
        t, lane = _in_place(t, n, batch)
        _require(t, lead, name, contiguous=False)
        st = t.stride()
        ops.append(t)
        strides += [lane, st[n - 1], st[0] if n == 2 else 0]
    dev = ops[0].device
    out = torch.empty((3, 3) + lead + (lanes,), dtype=torch.int64,
                      device=dev)
    if lanes > 0:
        for m in (fuse, asing, bsing):
            m = torch.as_tensor(m, device=dev)
            if m.dtype != torch.bool:
                raise TypeError(f"{name}: masks must be bool, not {m.dtype}")
            m, lane = _in_place(m, 0, batch)
            ops.append(m.view(torch.uint8))
            strides += [lane, 0, 0]
        ptrs = (ctypes.c_uint64 * 15)(*[t.data_ptr() for t in ops])
        st = (ctypes.c_int64 * 45)(*strides)
        kern = KERNELS[name]
        fn = getattr(_lib(kern.lib), "kzg_" + name)
        _check(fn(ctypes.cast(ptrs, _VP), ctypes.cast(st, _VP),
                  out.data_ptr(), lanes, _consts(G), lead[-1], _stream()),
               name)
        kern.count(lanes)
    return tuple(_unpack(out[j], batch) for j in range(3))
