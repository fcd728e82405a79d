"""Multi-process bring-up over torch.distributed (counterpart of
kzg_tpu/parallel/distributed.py).

The JAX package forms one cluster with jax.distributed and spans every chip
with one 1-D Mesh; the port forms a torch.distributed process group with one
process per rank and describes it with a 1-D :class:`Mesh`: the group, this
rank, the world size and this rank's device. The coefficient-axis shardings
of parallel.sharded (MSM, setup generation) and parallel.ntt (four-step NTT)
take that mesh.

The backend is the caller's choice and is never switched: ``gloo`` for the
CPU and for several ranks sharing one card (its collectives take host
tensors, so the port stages device tensors through the host), ``nccl``
where each rank has a card of its own (NCCL refuses two ranks on one GPU).

Usage (one process per rank, e.g. under torchrun)::

    from kzg_tpu_torch.parallel.distributed import init_distributed, global_mesh
    init_distributed("nccl")           # False (nothing done) without a job
    mesh = global_mesh()               # every rank; cuda:(rank mod cards)
    run = sharded_msm(eng, mesh)       # parallel.sharded
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..context import resolve_device


def init_distributed(backend: str, init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> bool:
    """Join the process group of a multi-process job; True if one was
    formed (or already exists).

    Without arguments the group's address, world size and rank come from the
    environment torchrun sets (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK);
    explicit values override, e.g. init_method=f"file://{tmp}/rdv" with tmp
    a directory of this job's own (tempfile.mkdtemp()), or
    "tcp://localhost:29500". When none is given and none is set,
    the process is left alone as a single process: False."""
    if dist.is_available() and dist.is_initialized():
        return True
    env_job = all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE",
                                            "RANK"))
    if init_method is None and not env_job:
        return False
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: the process group (None for a single process),
    this rank's index in it, its size and this rank's device."""
    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def staged(self) -> bool:
        """Whether collectives take host tensors (gloo) while this rank's
        tensors lie on a card: then they go through the host."""
        if self.group is None:
            return False
        return dist.get_backend(self.group) == "gloo" and \
            self.device.type != "cpu"


def rank_device(rank: int, device=None) -> torch.device:
    """Rank r's device: cuda:(r mod device_count), or the CPU when asked
    (device="cpu"); no card raises unless the CPU was asked for."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve_device(device)                     # raises without a card
    return torch.device("cuda", rank % torch.cuda.device_count())


def global_mesh(max_devices: int | None = None, device=None) -> Mesh | None:
    """The 1-D mesh over every rank of the job (a single process without
    one), or over its first `max_devices` ranks: then the ranks outside
    get None. Collective: every rank of the job calls it."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None, 0, 1, rank_device(0, device))
    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD
    if max_devices is not None and max_devices < world:
        group = dist.new_group(list(range(max_devices)))
        if rank >= max_devices:
            return None
        world = max_devices
    return Mesh(group, rank, world, rank_device(rank, device))


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, *t.shape): every rank's t in rank order, on this rank's
    device."""
    if mesh.group is None:
        return t[None]
    src = t.contiguous().cpu() if mesh.staged else t.contiguous()
    out = torch.empty((mesh.size,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return out.to(mesh.device)


def all_to_all(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t (size, ...): block j goes to rank j; returns (size, ...) whose
    block i came from rank i, on this rank's device."""
    if mesh.group is None:
        return t
    src = t.contiguous().cpu() if mesh.staged else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out.to(mesh.device)
