"""Multi-device scaling: MSM and trusted-setup generation over a mesh of
ranks (counterpart of kzg_tpu/parallel/sharded.py).

The *coefficient axis* is the scaling axis: scalars and setup points are
split into contiguous blocks, one per rank; every rank runs the full
Pippenger pipeline (``MSMEngine.msm``) on its block, and the partial sums
(one group element each) are all-gathered and added in rank order by
complete adds (EC addition is not linear, so this replaces the all-reduce a
tensor workload would use). Setup generation shards the element axis of the
fixed-base comb: each rank computes s^i G for its range of i from the shared
window table (the reference's thread fan-out over setup ranges).

The MSM takes each rank's own block (``shard`` cuts it from a full array,
``gather`` puts the blocks back together); the axis must divide into equal
blocks, as the JAX package's shard_map requires.
"""

from __future__ import annotations

import torch

from ..ops.msm import MSMEngine
from .distributed import Mesh, all_gather, global_mesh


def make_mesh(n_devices: int, device=None) -> Mesh:
    """The mesh over the first `n_devices` ranks of the job (the single
    process when n_devices is 1 and no job was formed); None on the ranks
    outside it."""
    mesh = global_mesh(max_devices=n_devices, device=device)
    if mesh is not None and mesh.size != n_devices:
        raise ValueError(f"a mesh of {n_devices} ranks needs a job of at "
                         f"least {n_devices} processes, not {mesh.size}")
    return mesh


def _leaves(x, fn):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def shard(x, mesh: Mesh):
    """This rank's contiguous block of the last axis of a tensor or of each
    tensor of a point dict."""
    def cut(v):
        n = v.shape[-1]
        if n % mesh.size:
            raise ValueError(f"{n} elements do not split over {mesh.size} "
                             "ranks")
        b = n // mesh.size
        return v[..., mesh.rank * b:(mesh.rank + 1) * b]
    return _leaves(x, cut)


def gather(x, mesh: Mesh):
    """The blocks of every rank concatenated along the last axis, in rank
    order (the inverse of shard), on every rank."""
    def cat(v):
        g = torch.movedim(all_gather(v, mesh), 0, -2)     # (..., size, b)
        return g.reshape(g.shape[:-2] + (-1,))
    return _leaves(x, cat)


def sharded_msm(eng: MSMEngine, mesh: Mesh):
    """run(scalars, points): this rank's block of raw scalars (L, b) and
    points (batch (b,)); every rank returns the total as one projective
    point (batch ())."""
    J = eng.J

    def run(scalars, points):
        part = eng.msm(scalars, points)               # this block's sum
        parts = {k: all_gather(v, mesh) for k, v in part.items()}
        acc = {k: v[0] for k, v in parts.items()}
        for i in range(1, mesh.size):
            acc = J.add(acc, {k: v[i] for k, v in parts.items()})
        return acc

    return run


def sharded_setup_powers(curve, mesh: Mesh):
    """run(digits, table): the s-power byte digits (W, n) of every setup
    element (``protocol.api.power_digits``) and the comb's window table
    (``Curve.window_table``), both the same on every rank; each rank
    computes and returns its block of the setup points s^i G (batch
    (n / size,)); gather() puts them together."""
    def run(digits, table):
        return curve.mul_digits_table(shard(digits, mesh), table)

    return run
