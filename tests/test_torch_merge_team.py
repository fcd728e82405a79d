"""K6, the merge combine (kzg_tpu_torch/csrc/msm_merge.cu), run on the CPU.

K6 runs its group's add schedule (kzg_tpu_torch.ops.team) over (aR, bL) on
the lane-team executor, then the merge's selects from the add's output
slots. Here team.plain_merge runs the same words through the plain
interpreter team.run and must equal MSMEngine._combine_plain (the plain
version of K6, itself held to kzg_tpu in test_torch_groups.py) on seeded
points (numpy seed) at an odd width, with every pattern of the three
masks: mid, newL and newR as canonical affine points and against the
python-int oracle, kept lanes' limbs unchanged, mid re-reduced.

The wrapper cuda.merge_combine reads a merge level's stride-2 halves in
place: given through a fake kernel library that reads the operands back
from the raw pointers and strides it receives and runs team.plain_merge
with the team block behind the constants, the halves of a level's sums
must give the limbs that contiguous copies of them give, with the halves'
own storage as the pointers.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from kzg_tpu_torch.context import get_context
from kzg_tpu_torch.ops import cuda, team
from kzg_tpu_torch.ops.msm import MSMEngine
from kzg_tpu_torch.refmodel.model import G1, G2

torch.set_num_threads(2)

SEED = 20261019
N = 9                                  # odd: lane i has mask pattern i % 8


@functools.lru_cache(maxsize=None)
def _batch(grp):
    """aL, aR, bL, bR over N lanes (aR + bL doubles in lane 0, cancels in
    lane 1, lanes 2-4 hold infinity), rescaled projectively, with their
    oracle points, and the masks fuse, asing, bsing (bits of i % 8)."""
    ctx = get_context("BN254", "cpu")
    J, og = (ctx.g2, G2(ctx.cp)) if grp == "g2" else (ctx.g1, G1(ctx.cp))
    rng = np.random.default_rng(SEED)
    pool = [og.mul(int(k), og.gen) for k in rng.integers(1, 1 << 20, 6)]
    pts = [[pool[int(j)] for j in rng.integers(0, 6, N)] for _ in range(4)]
    aL, aR, bL, bR = pts
    bL[0] = aR[0]                                    # P + P
    bL[1] = og.neg(aR[1])                            # P + (-P)
    aR[2] = None                                     # inf + Q
    bL[3] = None                                     # P + inf
    aR[4] = bL[4] = aL[5] = bR[6] = None             # inf + inf, kept inf
    p = ctx.cp.p

    def rand():
        return int.from_bytes(rng.bytes(40), "little") % p

    def rescaled(pp):
        P = J.encode_points(pp)
        lam = J.F.encode([(rand(), rand() or 1) if grp == "g2"
                          else rand() or 1 for _ in range(N)])
        return {k: J.F.mul(v, lam) for k, v in P.items()}

    bits = np.arange(N) % 8
    masks = [torch.from_numpy((bits >> b) & 1 == 1) for b in range(3)]
    eng = MSMEngine(J, ctx.fr, ctx.cp.r, strategy="merge")
    return J, og, eng, [rescaled(pp) for pp in pts], pts, masks


def _packed(J, outs):
    """Canonical packed affine arrays of point batches (one inversion)."""
    both = J.affine_packed({k: torch.cat([P[k] for P in outs], dim=-1)
                            for k in outs[0]})
    return both.split([P["x"].shape[-1] for P in outs], dim=-1)


def _fresh(J, P):
    """Exact 16-bit limbs, each component < 1.1 p."""
    B = J.F.base if J.is_fp2 else J.F
    for v in P.values():
        flat = (v.movedim(0, 1) if J.is_fp2 else v).reshape(B.L, -1)
        assert int(flat.max()) <= 0xFFFF
        vals = [sum(int(c) << (16 * k) for k, c in enumerate(col))
                for col in flat.T.tolist()]
        assert max(vals) < B.modulus * 11 // 10


@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_merge_program_matches_combine_plain(grp):
    J, og, eng, (aL, aR, bL, bR), pts, masks = _batch(grp)
    got = team.plain_merge(J, aL, aR, bL, bR, *masks)
    want = eng._combine_plain(aL, aR, bL, bR, *masks)
    packed = _packed(J, list(got) + list(want))
    for a, b in zip(packed[:3], packed[3:]):
        assert torch.equal(a, b)
    fuse, asing, bsing = [m.tolist() for m in masks]
    mid = [og.add(a, b) for a, b in zip(pts[1], pts[2])]
    assert J.unpack_affine(packed[0]) == mid
    assert J.unpack_affine(packed[1]) == [
        m if f and s else a for m, a, f, s in zip(mid, pts[0], fuse, asing)]
    assert J.unpack_affine(packed[2]) == [
        m if f and s else b for m, b, f, s in zip(mid, pts[3], fuse, bsing)]
    _fresh(J, got[0])
    for out, src, sel in ((got[1], aL, masks[1] & masks[0]),
                          (got[2], bR, masks[2] & masks[0])):
        for k in ("x", "y", "z"):
            assert torch.equal(out[k][..., ~sel], src[k][..., ~sel])
            assert torch.equal(out[k][..., sel], got[0][k][..., sel])


class _FakeMerge:
    """Stands in for K6's library: reads the operands back from the raw
    pointers and strides as msm_merge.cu addresses them, runs
    team.plain_merge with the team block behind K1's constants, and writes
    the kernel's output layout."""

    def __init__(self, G):
        self.G = G
        self.ptrs = self.strides = None

    def __call__(self, ptrs, strides, out, lanes, consts, n_limbs, stream):
        G = self.G
        B = G.F.base if G.is_fp2 else G.F
        L = B.L
        assert n_limbs == L and stream is None
        ptrs = ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_uint64))[:15]
        st = ctypes.cast(strides, ctypes.POINTER(ctypes.c_int64))[:45]
        st = [st[3 * q:3 * q + 3] for q in range(15)]
        self.ptrs, self.strides = ptrs, st
        words = ctypes.cast(consts, ctypes.POINTER(ctypes.c_uint32))
        at = 2 * L + 1 + team.ROWS * L                 # the table's header
        n_lv, n_ins = words[at + team.LEVELS], words[at + team.INSTRS]
        blk = words[2 * L + 1:at + team.HDR + n_lv + 3 * n_ins]
        lead = (2, L) if G.is_fp2 else (L,)

        def read(q, dtype, shape):
            lane, limb, comp = st[q]
            el = np.dtype(dtype).itemsize
            span = (lanes - 1) * lane + (L - 1) * limb * (len(shape) > 1) \
                + comp * (len(shape) > 2) + 1
            buf = np.ctypeslib.as_array(
                (ctypes.c_byte * (span * el)).from_address(ptrs[q]))
            steps = {1: (lane,), 2: (limb, lane), 3: (comp, limb, lane)}
            view = np.lib.stride_tricks.as_strided(
                buf.view(dtype), shape,
                [s * el for s in steps[len(shape)]])
            return torch.from_numpy(view.copy())

        pts = [{k: read(3 * i + c, np.int64, lead + (lanes,))
                for c, k in enumerate(("x", "y", "z"))} for i in range(4)]
        masks = [read(12 + m, np.uint8, (lanes,)).bool() for m in range(3)]
        res = team.plain_merge(G, *pts, *masks, blk=blk)
        dst = np.ctypeslib.as_array(
            (ctypes.c_int64 * (9 * int(np.prod(lead)) * lanes))
            .from_address(out)).reshape((3, 3) + lead + (lanes,))
        for j, P in enumerate(res):
            for c, k in enumerate(("x", "y", "z")):
                dst[j, c] = P[k].numpy()
        return 0


def _fake_lib(J, grp, monkeypatch):
    """cuda.merge_combine's library, stream and operand check replaced so
    that it runs on CPU tensors through a _FakeMerge, which is returned."""
    fake = _FakeMerge(J)
    name = "kzg_merge_combine_" + grp
    monkeypatch.setattr(cuda, "_lib", lambda lib: type("Lib", (), {
        name: staticmethod(fake)}))
    monkeypatch.setattr(cuda, "_stream", lambda: None)
    monkeypatch.setattr(cuda, "_require", lambda *a, **k: None)
    return fake


def _flat(J, P):
    """A point dict with batch axes flattened to one (contiguous)."""
    n = 2 if J.is_fp2 else 1
    return {k: v.reshape(v.shape[:n] + (-1,)) for k, v in P.items()}


@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_merge_wrapper_reads_strided_halves_in_place(grp, monkeypatch):
    """A level's sums over (W = 3, m = 6): aL, bL are the even and odd
    lanes of sumL, aR, bR of sumR (uniform lane stride 2, base offset 0 or
    1); the wrapper passes their own storage and strides, and the result
    equals that of contiguous copies and of MSMEngine._combine_plain."""
    J, og, eng, (aL, aR, bL, bR), pts, masks = _batch(grp)
    fake = _fake_lib(J, grp, monkeypatch)
    n = 2 if J.is_fp2 else 1

    def interleave(A, B):                  # (..., 3, 3) pairs -> (..., 3, 6)
        return {k: torch.stack([A[k], B[k]], dim=-1).reshape(
            A[k].shape[:n] + (3, 6)).contiguous() for k in A}

    def level(P):
        return {k: v.reshape(v.shape[:n] + (3, 3)) for k, v in P.items()}

    sumL = interleave(level(aL), level(bL))
    sumR = interleave(level(aR), level(bR))
    halves = [{k: v[..., j::2] for k, v in S.items()}
              for S, j in ((sumL, 0), (sumR, 0), (sumL, 1), (sumR, 1))]
    fuse, asing, bsing = [m.reshape(3, 3) for m in masks]
    single = torch.stack([asing, bsing], dim=-1).reshape(3, 6)
    got = cuda.merge_combine(J, *halves, fuse, single[:, 0::2],
                             single[:, 1::2])
    for i, P in enumerate(halves):
        for c, k in enumerate(("x", "y", "z")):
            assert fake.ptrs[3 * i + c] == P[k].data_ptr()
    assert fake.ptrs[12:] == [m.data_ptr() for m in (fuse, single,
                                                     single[:, 1::2])]
    copies = cuda.merge_combine(J, *[{k: v.contiguous() for k, v in P.items()}
                                     for P in halves],
                                fuse, asing.clone(), bsing.clone())
    for a, b in zip(got, copies):
        for k in ("x", "y", "z"):
            assert torch.equal(a[k], b[k])
    want = eng._combine_plain(aL, aR, bL, bR, *masks)
    packed = _packed(J, [{k: v.reshape(v.shape[:n] + (N,))
                          for k, v in P.items()} for P in got] + list(want))
    for a, b in zip(packed[:3], packed[3:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_merge_wrapper_copies_what_it_cannot_read_in_place(grp, monkeypatch):
    """Over a (3, 3) batch: aL and the fuse mask as transposed views (batch
    axes that flatten to no one lane stride) and bR as one point per row
    broadcast along the row go to the kernel as contiguous copies with
    lane stride 1, while aR, bL and the other masks are read in place; the
    result equals that of contiguous operands and of
    MSMEngine._combine_plain on the same lanes, and a mask that is not
    bool is refused."""
    J, og, eng, (aL, aR, bL, bR), pts, masks = _batch(grp)
    fake = _fake_lib(J, grp, monkeypatch)
    n = 2 if J.is_fp2 else 1
    grid = {k: v.reshape(v.shape[:n] + (3, 3)) for k, v in aL.items()}
    aLt = {k: v.transpose(-1, -2) for k, v in grid.items()}
    bRb = {k: v[..., 0::3].unsqueeze(-1) for k, v in bR.items()}
    aRg, bLg = [{k: v.reshape(v.shape[:n] + (3, 3)) for k, v in P.items()}
                for P in (aR, bL)]
    fuse, asing, bsing = [m.reshape(3, 3) for m in masks]
    fuse_t = fuse.t()
    got = cuda.merge_combine(J, aLt, aRg, bLg, bRb, fuse_t, asing, bsing)
    ins = (aLt, aRg, bLg, bRb)
    for i, P in enumerate(ins):
        for c, k in enumerate(("x", "y", "z")):
            copied = i in (0, 3)
            assert (fake.ptrs[3 * i + c] == P[k].data_ptr()) != copied
            if copied:
                assert fake.strides[3 * i + c][0] == 1
    assert fake.ptrs[12] != fuse_t.data_ptr()
    assert fake.ptrs[13:] == [asing.data_ptr(), bsing.data_ptr()]
    full = [{k: v.expand(v.shape[:-1] + (3,)).contiguous()
             for k, v in P.items()} if P is bRb else
            {k: v.contiguous() for k, v in P.items()} for P in ins]
    copies = cuda.merge_combine(J, *full, fuse_t.contiguous(), asing, bsing)
    for a, b in zip(got, copies):
        for k in ("x", "y", "z"):
            assert torch.equal(a[k], b[k])
    want = eng._combine_plain(*[_flat(J, P) for P in full],
                              *[m.reshape(-1) for m in (fuse_t.contiguous(),
                                                        asing, bsing)])
    packed = _packed(J, [_flat(J, P) for P in got] + list(want))
    for a, b in zip(packed[:3], packed[3:]):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="bool"):
        cuda.merge_combine(J, aLt, aRg, bLg, bRb, fuse_t.to(torch.uint8),
                           asing, bsing)
