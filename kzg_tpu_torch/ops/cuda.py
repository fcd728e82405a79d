"""Build, bind and launch layer of the port's hand-written CUDA kernels.

Counterpart of kzg_tpu/ops/fuse.py, the JAX package's one Pallas tiler:
where the tiler traced a pointwise function into one VMEM-resident TPU
kernel, each of its call sites is here a kernel written by hand for Hopper
(sm_90a):

  K1 ``mont_mul``         (csrc/mont_mul.cu)  — Montgomery multiply (T1): a
                                                thread per lane from
                                                K1_TEAM_BELOW lanes up, lane
                                                teams (ops/k1_team.py) below;
  K2 ``g1_add``           (csrc/g1_ops.cu)    — G1 complete add with reset
                                                mask (T2, T4, T6, T7);
  K3 ``g1_dbl``           (csrc/g1_ops.cu)    — chain of G1 doublings (T3);
  K4 ``g2_add``           (csrc/g2_ops.cu)    — G2 complete add with reset
                                                mask (T2, T4, T6, T7);
  K5 ``g2_dbl``           (csrc/g2_ops.cu)    — chain of G2 doublings (T3);
                                                K2-K5 on the split
                                                executor below
                                                SPLIT_BELOW lanes;
  K6 ``merge_combine_g1`` / ``merge_combine_g2`` (csrc/msm_merge.cu) — the
                          merge strategy's per-level combine (T5); its
                          products on 32-bit digits at the limb counts of
                          team.MERGE_DIGITS (25).

K2-K6 run lane teams (csrc/team.cuh) over the constant rows and schedule
table of ops/team.py (K6 runs the add's schedule, in a layout of its own
from team.MERGE_WIDE lanes up). A group's constant array is K1's modulus
words (p, R mod p, n0, n1: 2 L + 2 uint32 of the base field), then that team
block (_g1_consts, _g2_consts); K2-K5 below SPLIT_BELOW run the split
executor, each product split over a sub-team of ranks, from a block of
their own (team.split_block).

The limb count L is a compile-time constant of the sources (``-DKZG_L``):
each source compiles once per limb count it is asked for, 17 for BN254's
Fp and Fr and BLS12-381's Fr, 25 for BLS12-381's Fp, 11 for BN158's Fp
and Fr; every source is built at all three. A wrapper picks the library
by its field's L; the kernels of a 17-limb field count their launches
under their names (``mont_mul``), the others under name@L
(``mont_mul@25``, ``merge_combine_g1@11``).

Each source compiles at first use with nvcc into a shared library with a
plain C interface under ``build/kzg_tpu_torch/`` at the root of the
checkout (named by a hash of the sources, flags and limb count, so a stale
library is never loaded), and is loaded with ctypes. ``build()`` compiles
all sources at once, one nvcc process each.

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

from . import k1_team, team

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kzg_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"mont_mul": "mont_mul.cu", "g1_ops": "g1_ops.cu",
           "g2_ops": "g2_ops.cu", "msm_merge": "msm_merge.cu"}
HEADERS = ["mont.cuh", "team.cuh"]
BASE_L = 17             # the limb count whose kernels keep their bare names
# the limb counts every source is built at: 17 (BN254, BLS12-381 Fr), 25
# (BLS12-381 Fp) and 11 (BN158)
LIMBS = (BASE_L, 25, 11)
# K1 launches below this many lanes run the lane-team kernel (layout
# k1_team.LAYOUT), wider ones a thread per lane; per limb count, the width
# from which the thread-per-lane kernel is as fast (team_sweep.py k1 on
# the H100, PERF.md run Z6: at 17 limbs the team takes 0.93 x its time at
# 3072 lanes and 1.01 x at 3584; at 25, 0.94 x at 5120 and 1.05 x at 5632;
# at 11, 0.96 x at 1536 and 1.00 x at 2048)
K1_TEAM_BELOW = {BASE_L: 3072, 25: 5120, 11: 2048}
# The width rule of the four point kernels: K2 (g1_add), K3 (g1_dbl,
# lanes whatever `times`), K4 (g2_add) and K5 (g2_dbl) launches below this
# many lanes run the split executor (layout team.SPLIT_LAYOUT), wider ones
# the lane executor; per kernel and limb count (none: the lane executor
# at every width), from team_sweep.py on the H100 (PERF.md). At 25 limbs,
# G2 (run AD5): K4's split executor takes 0.81 x the lane executor's time
# at 512 lanes and 1.09 x at 768; K5's 0.83 x at 512 x 8 and 1.48 x at
# 1024 x 8; G1 (run AE1): K2's 0.80 x at 512 lanes and 1.11 x at 768; K3's
# 0.95 x at 1024 x 8 and 1.67 x at 2048 x 8. At 11 limbs: K4's 0.52 x at 1
# lane, 0.59 x at 256 and 1.05 x at 512 (run AG1); K2's 0.79 x at 1 lane
# and 0.98 x at 512 (AG1), 0.90 x at 320 and 1.48 x at 620, the BN158
# paths' widths either side of the rule (run AG2's sweep); K5's 0.51 x at
# 1 x 8, 0.57 x at 256 x 8 and 1.08 x at 512 x 8, K3's 0.61 x at 1 x 8,
# 0.68 x at 512 x 8 and 1.22 x at 768 x 8 (run AH2, in the layouts the
# BN158 paths' launches pick; the paths launch them at 1 x 8 and 5000 x 8).
# At 17 limbs, the adds alone (run AI2, in the layouts the BN254 paths'
# launches pick): K4's 0.44 x at 1 lane, 0.95 x at 512 and 1.08 x at 544;
# K2's 0.63 x at 1 lane, 0.89 x at 512 and 1.23 x at 544 (a second wave
# of split blocks from 529 lanes: 4 blocks of 192 threads an SM at 72
# registers); K3 and K5 keep the lane executor there
SPLIT_BELOW = {"g1_add": {25: 768, 11: 620, 17: 544},
               "g1_dbl": {25: 2048, 11: 768},
               "g2_add": {25: 768, 11: 512, 17: 544},
               "g2_dbl": {25: 1024, 11: 512}}


class Kernel:
    """Launch counter and provenance of one hand-written kernel at one limb
    count."""

    def __init__(self, name, lib, source, replaces, limbs=BASE_L):
        self.name = name
        self.lib = lib                 # key of SOURCES
        self.source = source           # path in the repo
        self.replaces = replaces       # the TPU kernel's call site(s)
        self.limbs = limbs             # the L it is built for (-DKZG_L)
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


def kernel_key(name, limbs):
    """The KERNELS key of kernel `name` built for `limbs` limbs."""
    return name if limbs == BASE_L else f"{name}@{limbs}"


KERNELS.update({kernel_key(k.name, L): Kernel(k.name, k.lib, k.source,
                                                k.replaces, L)
                for L in LIMBS if L != BASE_L for k in KERNELS.values()})


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


def _flags(limbs):
    return NVCC_FLAGS + [f"-DKZG_L={limbs}"]


def _so_path(name, limbs=BASE_L):
    h = hashlib.sha256(" ".join(_flags(limbs)).encode())
    for f in [SOURCES[name]] + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}_L{limbs}_{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES), limbs=(BASE_L,)):
    """Compile the given sources (default: all) at each of the limb counts
    `limbs` that are not built yet, one nvcc process each, all started
    together. Returns {kernel_key(name, L): seconds}."""
    jobs = [(name, L) for L in limbs for name in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.time()
    for name, L in jobs:
        so = _so_path(name, L)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        key = kernel_key(name, L)
        log = open(BUILD_DIR / f"{key}.log", "w")
        cmd = [nvcc, *_flags(L), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[key] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), tmp, so,
                      log)
    secs = {}
    failed = []
    while len(secs) < len(procs):          # each source's own finish time
        for key, (proc, tmp, so, log) in procs.items():
            if key in secs or proc.poll() is None:
                continue
            log.close()
            secs[key] = time.time() - t0
            if proc.returncode != 0:
                failed.append(key)
            else:
                os.replace(tmp, so)
        time.sleep(0.1)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{k}.log").read_text()[-4000:]
                         for k in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return secs


def build_log(name, limbs=BASE_L):
    """nvcc's output (ptxas register and spill report) of the last build."""
    p = BUILD_DIR / f"{kernel_key(name, limbs)}.log"
    return p.read_text() if p.exists() else ""


_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    "kzg_mont_mul": [_VP, _VP, _VP, _I64, _VP, _INT, _VP],
    "kzg_mont_mul_team": [_VP, _VP, _VP, _I64, _VP, _INT, _VP, _VP],
    "kzg_k1_empty": [_I64, _INT, _VP],
    "kzg_g1_add": [_VP] * 8 + [_I64, _VP, _INT, _VP],
    "kzg_g1_dbl": [_VP] * 4 + [_I64, _INT, _VP, _INT, _VP],
    "kzg_g1_add_split": [_VP] * 8 + [_I64, _VP, _INT, _VP],
    "kzg_g1_dbl_split": [_VP] * 4 + [_I64, _INT, _VP, _INT, _VP],
    "kzg_g2_add": [_VP] * 8 + [_I64, _VP, _INT, _VP],
    "kzg_g2_dbl": [_VP] * 4 + [_I64, _INT, _VP, _INT, _VP],
    "kzg_g2_add_split": [_VP] * 8 + [_I64, _VP, _INT, _VP],
    "kzg_g2_dbl_split": [_VP] * 4 + [_I64, _INT, _VP, _INT, _VP],
    "kzg_merge_combine_g1": [_VP] * 3 + [_I64, _VP, _INT, _VP],
    "kzg_merge_combine_g2": [_VP] * 3 + [_I64, _VP, _INT, _VP],
}


def _lib(name, limbs=BASE_L):
    with _lock:
        key = (name, limbs)
        if key not in _libs:
            so = _so_path(name, limbs)
            if not so.exists():
                build([name], (limbs,))
            lib = ctypes.CDLL(str(so))
            for fn, args in _ARGTYPES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[key] = lib
        return _libs[key]


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


def mod_words(F):
    """p, R mod p, n0, n1 — the layout of mont.cuh mod_from_host (2 L + 2
    words)."""
    return (list(F.params.limbs) + list(F.params.one_limbs)
            + [F.n0, k1_team.n1(F)])


def _mod_consts(F):
    """mod_words(F) as a uint32 array, kept on F."""
    c = getattr(F, "_k1_consts", None)
    if c is None:
        c = _u32(mod_words(F))
        F._k1_consts = c
    return c


_k1_tables = {}


def k1_table(L):
    """K1's team table at L limbs (k1_team.table at k1_team.LAYOUT), built
    once; team_sweep.py replaces an entry to time another layout."""
    if L not in _k1_tables:
        _k1_tables[L] = _u32(k1_team.table(L))
    return _k1_tables[L]


def _g1_consts(G, split=False):
    """K1's constants, then the lane-team block of K2/K3/K6 (team.block),
    or with `split` the split executor's (team.split_block). The schedules
    follow Curve._add_plain / _dbl_plain on either branch of
    3b (a lazy small multiple when 3b <= 14: BN254's 6, BLS12-381's 12; a
    full product above: BN158's 39) and on the branch of 9b > 15 (a full
    product); a curve with 9b <= 15 raises."""
    b3 = G._b3_int
    if not 3 * b3 > 15:
        raise ValueError(f"{G.name}: the G1 kernels take 9b > 15, not "
                         f"3b = {b3}")
    return mod_words(G.F) + (team.split_block(G) if split else team.block(G))


def _g2_consts(G, split=False):
    """K1's constants of the base field, then the lane-team block of
    K4/K5/K6 (team.block), or with `split` the split executor's
    (team.split_block). The schedules take Fp2 with qnr = -1 (BN254,
    BLS12-381) or qnr = 5 (BN158, c0 = v0 + 5 v1 lazy); other curves
    raise."""
    F2 = G.F
    if not (F2.qnr_is_m1 or F2.qnr_small == 5):
        raise ValueError(f"{G.name}: the G2 kernels take qnr = -1 or 5")
    return (mod_words(F2.base)
            + (team.split_block(G) if split else team.block(G)))


def _consts(G, split=False):
    """The constant block of G's point kernels (with `split`: of the split
    K2-K5), built once per curve."""
    attr = "_kernel_split_consts" if split else "_kernel_consts"
    c = getattr(G, attr, None)
    if c is None:
        c = _u32(_g2_consts(G, split) if G.is_fp2 else _g1_consts(G, split))
        setattr(G, attr, c)
    return ctypes.cast(c, _VP)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def k1_uses_team(L, lanes, team=None):
    """Whether K1 runs its lane-team kernel over `lanes` lanes at L limbs:
    below K1_TEAM_BELOW[L], unless `team` (True or False) says which."""
    return lanes < K1_TEAM_BELOW[L] if team is None else team


def mont_mul(F, a, b, team=None):
    """K1: Montgomery product of two equally shaped (L, *batch) int64 limb
    tensors on the card (a broadcast input is materialized first). The
    lane-team kernel below K1_TEAM_BELOW[L] lanes, the thread-per-lane one
    from there up; `team` True or False forces one (for timing both).
    Either counts under K1's key at L."""
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
    lib = _lib("mont_mul", F.L)
    mod = ctypes.cast(_mod_consts(F), _VP)
    if k1_uses_team(F.L, lanes, team):
        rc = lib.kzg_mont_mul_team(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   lanes, mod, F.L,
                                   ctypes.cast(k1_table(F.L), _VP),
                                   _stream())
    else:
        rc = lib.kzg_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              lanes, mod, F.L, _stream())
    _check(rc, "mont_mul")
    KERNELS[kernel_key("mont_mul", F.L)].count(lanes)
    return out


def k1_grid(L, lanes, team=None):
    """(blocks, threads per block) of K1's launch over `lanes` lanes at L
    limbs, in the variant the width rule (or `team`) picks."""
    if k1_uses_team(L, lanes, team):
        tab = k1_table(L)
        lpb = k1_team.lanes_per_block(tab)
        return -(-lanes // lpb), 32 * tab[1]
    return -(-lanes // 128), 128


def empty_launch(blocks, threads):
    """An empty kernel over `blocks` blocks of `threads` threads (built
    with K1's source): the device time of a launch that does no work.
    Counted nowhere."""
    _check(_lib("mont_mul").kzg_k1_empty(blocks, threads, _stream()),
           "empty kernel")


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


def uses_split(name, L, lanes, team=None):
    """Whether point kernel `name` (K2 "g1_add", K3 "g1_dbl", K4 "g2_add",
    K5 "g2_dbl") runs its split executor over `lanes` lanes at L limbs:
    below SPLIT_BELOW[name][L] (never at a limb count without an entry),
    unless `team` (True or False) says which."""
    if team is None:
        return lanes < SPLIT_BELOW[name].get(L, 0)
    return team


def _layout(name, L, split):
    """(threads per team, warps per block) of point kernel `name`'s shipped
    layout on the split or the lane executor."""
    grp, kind = name[:2], 0 if name.endswith("_add") else 1
    if split:
        return team.SPLIT_LAYOUT[grp][L][kind][:2]
    return team.LAYOUT[grp][kind]


def point_grid(name, L, lanes, team=None):
    """(blocks, threads per block) of point kernel `name`'s launch over
    `lanes` lanes at L limbs, in the variant the width rule (or `team`)
    picks."""
    split = uses_split(name, L, lanes, team)
    per, warps = _layout(name, L, split)
    lpb = 32 * warps // per if split else (32 // per) * warps
    return -(-lanes // lpb), 32 * warps


def _entry(name, L, lanes, team):
    """The C entry point of point kernel `name` for this launch, and
    whether it is the split executor's (by SPLIT_BELOW, or `team`)."""
    split = uses_split(name, L, lanes, team)
    return "kzg_" + name + ("_split" if split else ""), split


def _point_add(name, G, P, Q, reset, team=None):
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
    L = _lead(G)[-1]
    kern = KERNELS[kernel_key(name, L)]
    entry, split = _entry(name, L, lanes, team)
    fn = getattr(_lib(kern.lib, L), entry)
    _check(fn(*[t.data_ptr() for t in c], rptr, out.data_ptr(), lanes,
              _consts(G, split), L, _stream()), name)
    kern.count(lanes)
    return _unpack(out, batch)


def _point_dbl(name, G, P, times, team=None):
    if times < 1:
        raise ValueError(f"{name}: times must be >= 1")
    c, batch, lanes = _points(G, (P,), name)
    out = torch.empty((3,) + _lead(G) + (lanes,), dtype=torch.int64,
                      device=c[0].device)
    if lanes == 0:
        return _unpack(out, batch)
    L = _lead(G)[-1]
    kern = KERNELS[kernel_key(name, L)]
    entry, split = _entry(name, L, lanes, team)
    fn = getattr(_lib(kern.lib, L), entry)
    _check(fn(*[t.data_ptr() for t in c], out.data_ptr(), lanes, int(times),
              _consts(G, split), L, _stream()), name)
    kern.count((lanes, int(times)))
    return _unpack(out, batch)


def g1_add(G, P, Q, reset=None, team=None):
    """K2: out = reset ? Q : P + Q per lane (complete add), G1 point dicts
    of (L, *batch) int64 coordinates on the card; reset is a bool tensor of
    the batch shape or None. The split executor below
    SPLIT_BELOW["g1_add"][L] lanes, the lane executor from there up;
    `team` True or False forces one (for timing both; True raises at a
    limb count without a split layout). Either counts under K2's key."""
    return _point_add("g1_add", G, P, Q, reset, team)


def g1_dbl(G, P, times, team=None):
    """K3: 2^times P per lane, G1 point dict on the card; the variant by
    SPLIT_BELOW["g1_dbl"][L] and `team`, as g1_add."""
    return _point_dbl("g1_dbl", G, P, times, team)


def g2_add(G, P, Q, reset=None, team=None):
    """K4: out = reset ? Q : P + Q per lane (complete add), G2 point dicts
    of (2, L, *batch) int64 coordinates on the card; reset is a bool tensor
    of the batch shape or None. The split executor below
    SPLIT_BELOW["g2_add"][L] lanes, the lane executor from there up;
    `team` True or False forces one (for timing both; True raises at a
    limb count without a split layout). Either counts under K4's key."""
    return _point_add("g2_add", G, P, Q, reset, team)


def g2_dbl(G, P, times, team=None):
    """K5: 2^times P per lane, G2 point dict on the card; the variant by
    SPLIT_BELOW["g2_dbl"][L] and `team`, as g2_add."""
    return _point_dbl("g2_dbl", G, P, times, team)


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
        kern = KERNELS[kernel_key(name, lead[-1])]
        fn = getattr(_lib(kern.lib, lead[-1]), "kzg_" + name)
        _check(fn(ctypes.cast(ptrs, _VP), ctypes.cast(st, _VP),
                  out.data_ptr(), lanes, _consts(G), lead[-1], _stream()),
               name)
        kern.count(lanes)
    return tuple(_unpack(out[j], batch) for j in range(3))
