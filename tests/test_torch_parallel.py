"""The port's multi-device paths (kzg_tpu_torch.parallel) on the CPU: one
4-rank torch.distributed group over gloo, started once for this file
(torch.multiprocessing in spawn mode, a file:// rendezvous in pytest's
temporary directory), runs the sharded MSM and the sharded setup generation
on BN158 (the narrowest curve) and the four-step NTT on BLS12-381's Fr;
rank 0 gathers what every rank returned. Held exactly to the python-int
oracle, to the port's single-process setup and to kzg_tpu's NTT.

The ranks import this module, so its top level imports torch and the port
only; kzg_tpu and jax are imported inside the tests.
"""

import fcntl
import os
import pickle
import random

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

RANKS = 4
CURVE = "BN158"                  # the MSM's and the setup's; the narrowest
MSM_POINTS = 8
SETUP_TERMS = 8
SECRET = 0xC0FFEE_1234_5678_9ABC_DEF0
NTT_N = 64
SEED = 20261020


def _msm_inputs(cp):
    """MSM_POINTS scalars below r and multiples of the G1 generator."""
    rng = random.Random(SEED)
    scalars = [rng.randrange(cp.r) for _ in range(MSM_POINTS)]
    mults = [rng.randrange(1, cp.r) for _ in range(MSM_POINTS)]
    return scalars, mults


def _ntt_inputs(r):
    rng = np.random.default_rng(SEED)

    def rand(m):
        return [int.from_bytes(rng.bytes(40), "little") % r
                for _ in range(m)]
    return rand(NTT_N), rand(NTT_N // 2), rand(NTT_N // 2)


def _rank(rank, init_file, out_path):
    """One rank: the three subsystems on a mesh of RANKS CPU ranks; rank 0
    writes the gathered results to out_path."""
    import torch.distributed as dist

    import kzg_tpu_torch as kzg
    from kzg_tpu_torch.context import get_context
    from kzg_tpu_torch.ops.msm import MSMEngine
    from kzg_tpu_torch.ops.poly import PolyEngine
    from kzg_tpu_torch.parallel.distributed import init_distributed
    from kzg_tpu_torch.parallel.ntt import DistributedNTT
    from kzg_tpu_torch.parallel.sharded import (gather, make_mesh, shard,
                                                sharded_msm,
                                                sharded_setup_powers)
    from kzg_tpu_torch.protocol.api import power_digits
    from kzg_tpu_torch.refmodel.model import G1

    torch.set_num_threads(1)
    assert init_distributed("gloo", f"file://{init_file}", RANKS, rank)
    mesh = make_mesh(RANKS, device="cpu")
    res = {}

    # sharded MSM (merge strategy), G1
    pc = kzg.init(CURVE, device="cpu")
    ctx = pc.ctx
    og = G1(ctx.cp)
    scalars, mults = _msm_inputs(ctx.cp)
    sraw = ctx.fr.canon(ctx.fr.raw(scalars))
    pts = ctx.g1.encode_points([og.mul(m, og.gen) for m in mults])
    eng = MSMEngine(ctx.g1, ctx.fr, ctx.cp.r, strategy="merge")
    tot = sharded_msm(eng, mesh)(shard(sraw, mesh), shard(pts, mesh))
    res["msm"] = ctx.g1.decode_points({k: v[..., None]
                                       for k, v in tot.items()})[0]

    # sharded setup generation, G1 and G2
    digits = power_digits(ctx.cp.r, SECRET, SETUP_TERMS)
    wt1, wt2 = pc.comb_tables()
    for grp, G, wt in (("g1", ctx.g1, wt1), ("g2", ctx.g2, wt2)):
        block = sharded_setup_powers(G, mesh)(digits, wt)
        res[f"setup_{grp}_block"] = block["x"].shape[-1]
        res[f"setup_{grp}"] = G.decode_points(gather(block, mesh))
    if rank == 0:                 # the single-process setup, same tables
        ts = kzg.trusted_setup.from_secret(SECRET, SETUP_TERMS)
        res["from_secret"] = (ts._g1, ts._g2)

    # four-step NTT on BLS12-381's Fr
    bctx = get_context("BLS12381", "cpu")
    F = bctx.fr
    pe = PolyEngine(F, bctx.cp)
    x, a, b = _ntt_inputs(bctx.cp.r)
    dntt = DistributedNTT(pe, mesh)
    fwd = dntt(shard(F.encode(x), mesh))
    back = dntt(fwd, inverse=True)
    res["ntt"] = F.decode(gather(fwd, mesh))
    res["intt"] = F.decode(gather(back, mesh))
    ca = shard(pe._pad_last(F.encode(a), NTT_N), mesh)
    cb = shard(pe._pad_last(F.encode(b), NTT_N), mesh)
    out_n = len(a) + len(b) - 1
    blocks = [None] * RANKS
    dist.all_gather_object(blocks, F.decode(dntt.conv(ca, cb, out_n)))
    res["conv"] = [v for blk in blocks for v in blk]
    res["conv_block"] = len(blocks[-1])
    dist.barrier()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' gathered results, computed once per run: xdist spreads
    this file's tests over workers, so the first worker to get here starts
    the group under a lock in a directory the run's workers share, and the
    others read its results."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = tmp_path_factory.getbasetemp()
    if uid:
        root = root.parent / f"torch-parallel-{uid}"
        root.mkdir(exist_ok=True)
    out = root / "ranks.pkl"
    with open(root / "ranks.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = root / "rdv"
            mp.spawn(_rank, args=(str(tmp), str(out)), nprocs=RANKS,
                     join=True)
    with open(out, "rb") as f:
        return pickle.load(f)


def test_sharded_msm_matches_oracle(ranks):
    """Merge msm per rank over 2 of 8 points, partial sums added in rank
    order == the oracle's sum of k_i P_i."""
    from kzg_tpu.curves.params import get_curve
    from kzg_tpu.refmodel.model import G1
    cp = get_curve(CURVE)
    og = G1(cp)
    scalars, mults = _msm_inputs(cp)
    want = og.mul(sum(k * m for k, m in zip(scalars, mults)) % cp.r, og.gen)
    assert ranks["msm"] == want


def test_sharded_setup_matches_oracle_and_from_secret(ranks):
    """Each rank's 2 of 8 comb elements, gathered, == the oracle's s^i G1 /
    s^i G2 and the single-process from_secret setup (made on rank 0)."""
    from kzg_tpu.curves.params import get_curve
    from kzg_tpu.refmodel.model import G1, G2
    cp = get_curve(CURVE)
    og1, og2 = G1(cp), G2(cp)
    powers = [pow(SECRET, i, cp.r) for i in range(SETUP_TERMS)]
    assert ranks["setup_g1_block"] == ranks["setup_g2_block"] == 2
    assert ranks["setup_g1"] == [og1.mul(e, og1.gen) for e in powers]
    assert ranks["setup_g2"] == [og2.mul(e, og2.gen) for e in powers]
    assert (ranks["setup_g1"], ranks["setup_g2"]) == ranks["from_secret"]


def test_distributed_ntt_matches_kzg_tpu(ranks):
    """At n = 64 over 4 ranks on BLS12-381's Fr: forward == kzg_tpu's
    PolyEngine.ntt (jitted), the inverse returns the input, and conv of a
    32- and a 32-coefficient polynomial == the schoolbook product mod r."""
    import jax
    from kzg_tpu.curves.params import get_curve as jax_curve
    from kzg_tpu.fields.mont import Field as JField
    from kzg_tpu.fields.mont import ints_to_limbs, limbs_to_ints
    from kzg_tpu.ops.poly import PolyEngine as JPolyEngine
    jcp = jax_curve("BLS12381")
    jF = JField(jcp.fr)
    jpe = JPolyEngine(jF, jcp)
    r = jcp.r
    x, a, b = _ntt_inputs(r)
    mont = [v * jF.params.mont_r % r for v in x]
    jfwd = np.asarray(jax.jit(jpe.ntt)(ints_to_limbs(mont, jF.L)))
    want = [v * pow(jF.params.mont_r, -1, r) % r
            for v in limbs_to_ints(jfwd)]
    assert ranks["ntt"] == want
    assert ranks["intt"] == x
    assert ranks["conv_block"] == 15          # 63 = 3 x 16 + 15
    assert ranks["conv"] == [
        sum(a[i] * b[k - i] for i in range(len(a)) if 0 <= k - i < len(b))
        % r for k in range(len(a) + len(b) - 1)]


def test_init_distributed_without_a_job(monkeypatch):
    """No init_method and no MASTER_ADDR / WORLD_SIZE / RANK: False, and no
    group is formed; the mesh is then the single process."""
    import torch.distributed as dist
    from kzg_tpu_torch.parallel.distributed import (global_mesh,
                                                    init_distributed)
    from kzg_tpu_torch.parallel.sharded import make_mesh
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed("gloo") is False
    assert not dist.is_initialized()
    mesh = global_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device.type) == \
        (None, 0, 1, "cpu")
    assert make_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")
