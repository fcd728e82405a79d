"""K1's lane-team variant (kzg_tpu_torch/csrc/mont_mul.cu) run on the CPU.

Below cuda.K1_TEAM_BELOW lanes K1 gives each lane a team of T threads that
own contiguous ranges of the product columns (kzg_tpu_torch/ops/k1_team.py
states the table and models the rounds). Here k1_team.run, the plain
PyTorch model of the team's product, rounds and rank-by-rank carries over
that table, must equal Field._mul_plain (the plain version of K1) limb for
limb at every team size the kernel is built for, and kzg_tpu's Field.mul
in value at a tiny width, on BN254 (17 limbs), BLS12-381 (25) and BN158 (11), on
seeded lazy limbs up to 2^22 and at the widest product operands that the
point formulas give (ROADMAP, faults section: BLS12-381's G1 add ~2967 p
with limbs ~842,974 times ~248 p; BN158's G2 doubling 65.45 p with limbs
3,270,656). Exact equality: the arithmetic is integer.

cuda.mont_mul picks the variant by width: through a fake kernel library
that reads the operands and the team table back from the raw pointers, a
launch of K1_TEAM_BELOW[L] - 1 lanes must reach kzg_mont_mul_team and
one of K1_TEAM_BELOW[L] lanes kzg_mont_mul, each from the library built at
the field's limb count, counted under that limb count's K1 key.
"""

import ctypes

import jax
import numpy as np
import torch

from kzg_tpu.curves.params import get_curve as jax_curve
from kzg_tpu.fields.mont import Field as JField
from kzg_tpu_torch.curves.params import get_curve
from kzg_tpu_torch.fields.mont import Field, ints_to_limbs, limbs_to_ints
from kzg_tpu_torch.ops import cuda, k1_team

torch.set_num_threads(2)

SEED = 20261020
# (curve, value range of a in p, largest borrow, value range of b in p):
# the widest product operands of each curve's point formulas
WIDEST = {"BN254": ((1, 64), 63, (1, 64)),
          "BLS12381": ((2967, 2977), 12, (246, 248)),
          "BN158": ((65.45, 65.5), 49, (6.9, 7))}


def _limbs(vals, L, rng, borrow):
    """(L, n) int64 limbs of `vals` with up to `borrow` x 2^16 moved from
    each limb into the one below it (the values are unchanged)."""
    x = ints_to_limbs(vals, L).astype(np.int64)
    for i in range(L - 1):
        t = np.minimum(rng.integers(0, borrow + 1, len(vals)), x[i + 1])
        t[::3] = np.minimum(borrow, x[i + 1, ::3])       # the top borrow
        x[i] += t << 16
        x[i + 1] -= t
    return x


def _operands(F, curve, n, rng):
    """a, b as (L, n) int64: the first n // 2 lanes lazy (values below 64
    p, limbs up to 2^22 - 1, lanes 0-2 at 0, p and p - 1), the others at
    the curve's widest operands."""
    p, L = F.modulus, F.L
    (a0, a1), borrow, (b0, b1) = WIDEST[curve]

    def between(lo, hi, k):
        lo, hi = int(lo * p), int(hi * p)
        return [lo + int.from_bytes(rng.bytes(64), "little") % (hi - lo)
                for _ in range(k)]

    h = n // 2
    av = between(0, 64, h) + between(a0, a1, n - h)
    bv = between(0, 64, h) + between(b0, b1, n - h)
    av[:3] = [0, p, p - 1]
    a = np.concatenate([_limbs(av[:h], L, rng, 63),
                        _limbs(av[h:], L, rng, borrow)], axis=1)
    b = np.concatenate([_limbs(bv[:h], L, rng, 63),
                        _limbs(bv[h:], L, rng, 7)], axis=1)
    return torch.from_numpy(a), torch.from_numpy(b), av, bv


def _high_half_carries(L):
    """k1_team.high at every team size on crafted columns: high columns of
    0xFFFF under a carry of 1 or 2^40 from column L (a carry that crosses
    every rank's digits), random columns up to 2^50, zeros; equal to the
    columns' sum mod R in 16-bit digits."""
    rng = np.random.default_rng(SEED + L)
    n, top = 6, (1 << 50) - 1
    cols = np.full((2 * L, n), 0xFFFF, dtype=np.int64)
    cols[L, 0] += 1
    cols[L, 1] += 1 << 40
    cols[:, 2] = rng.integers(0, top, 2 * L)
    cols[rng.integers(L, 2 * L, 5), 3] = rng.integers(0, top, 5)
    cols[:, 4] = 0
    cols[:, 5] = top
    for T in k1_team.TEAMS:
        tab = k1_team.table(L, (T, 1))
        C = tab[2]
        t = torch.zeros((T, C, n), dtype=torch.int64)
        for r in range(T):
            for q in range(C):
                if r * C + q < 2 * L:
                    t[r, q] = torch.from_numpy(cols[r * C + q])
        got = torch.stack(k1_team.high(t, k1_team._ranges(tab), C, L))
        for lane in range(n):
            v = sum(int(cols[k, lane]) << 16 * (k - L)
                    for k in range(L, 2 * L)) % (1 << 16 * L)
            assert limbs_to_ints(got[:, lane]) == v, (L, T, lane)


def test_team_rounds_match_plain_and_kzg_tpu():
    """k1_team.run at every team size (and the shipped layout) equals
    _mul_plain limb for limb on all three curves, lazy and widest lanes;
    the high half's passes and carry-lookahead give the columns' sum on
    crafted columns (runs of 0xFFFF digits under a carry from below);
    the output is a b R^-1 mod p in exact 16-bit limbs below a b / R + p;
    the columns and the broadcast carries fit the kernel's 64-bit words
    (a carry below 2^48 packs beside m); kzg_tpu's Field.mul gives the
    same values (its limbs may be lazy) on the lazy lanes of a 6-lane
    batch."""
    rng = np.random.default_rng(SEED)
    for curve in ("BN254", "BLS12381", "BN158"):
        F = Field(get_curve(curve).fp, "cpu")
        p, L = F.modulus, F.L
        R = 1 << (16 * L)
        lpb = k1_team.lanes_per_block(k1_team.table(L))
        n = lpb * -(-16 // lpb) + 1           # one lane past a block
        a, b, av, bv = _operands(F, curve, n, rng)
        if curve != "BN254":
            assert int(a[:, n // 2:].max()) >= {25: 842974, 11: 3270656}[L]
            assert min(av[n // 2:]) >= {25: 2967, 11: 65.45}[L] * p
        want = F._mul_plain(a, b)
        for T in k1_team.TEAMS:
            stats = {}
            got = k1_team.run(F, a, b, k1_team.table(L, (T, 1)), stats)
            assert torch.equal(got, want), (curve, T)
            assert stats["column"] < 1 << 56 and stats["carry"] < 1 << 48
        for w in (1, k1_team.LAYOUT[L][0] - 1, k1_team.LAYOUT[L][0] + 1):
            assert torch.equal(k1_team.run(F, a[:, :w], b[:, :w]),
                               want[:, :w])
        _high_half_carries(L)
        rinv = pow(R, -1, p)
        got = limbs_to_ints(want)
        assert int(want.max()) <= 0xFFFF
        for x, y, z in zip(av, bv, got):
            assert z % p == x * y * rinv % p and z * R < x * y + R * p
        jF = JField(jax_curve(curve).fp)
        ja = a[:, :6].numpy().astype(np.uint32)
        jb = b[:, :6].numpy().astype(np.uint32)
        jout = np.asarray(jax.jit(jF.mul)(ja, jb)).astype(np.int64)
        assert limbs_to_ints(jout) == got[:6]


class _FakeK1:
    """Stands in for K1's library at one limb count: reads the operands
    (and the team table) back from the raw pointers and writes
    Field._mul_plain's (k1_team.run's under the table) to `out`."""

    def __init__(self, F, limbs):
        self.F, self.limbs, self.calls = F, limbs, []

    def _read(self, ptr, lanes):
        L = self.F.L
        return torch.from_numpy(np.ctypeslib.as_array(
            (ctypes.c_int64 * (L * lanes)).from_address(ptr)).reshape(
                L, lanes).copy())

    def _write(self, ptr, res):
        np.ctypeslib.as_array((ctypes.c_int64 * res.numel()).from_address(
            ptr))[:] = res.reshape(-1).numpy()

    def kzg_mont_mul(self, a, b, out, lanes, mod, n_limbs, stream):
        self.calls.append(("kzg_mont_mul", n_limbs))
        F = self.F
        self._write(out, F._mul_plain(self._read(a, lanes),
                                      self._read(b, lanes)))
        return 0

    def kzg_mont_mul_team(self, a, b, out, lanes, mod, n_limbs, tab,
                          stream):
        self.calls.append(("kzg_mont_mul_team", n_limbs))
        F = self.F
        words = ctypes.cast(tab, ctypes.POINTER(ctypes.c_uint32))
        team = words[0]
        tab = words[:3 + 2 * team]
        assert tab == k1_team.table(F.L)
        self._write(out, k1_team.run(F, self._read(a, lanes),
                                     self._read(b, lanes), tab))
        return 0


def test_wrapper_picks_the_variant_by_width(monkeypatch):
    """On BN254 (17 limbs), BLS12-381 (Fp, 25) and BN158 (11), just below
    K1_TEAM_BELOW[L] lanes cuda.mont_mul calls kzg_mont_mul_team with the
    team table of k1_team.LAYOUT, at K1_TEAM_BELOW[L] lanes kzg_mont_mul,
    both from the library built at L, each launch counted once under
    kernel_key("mont_mul", L) and in its lanes; the limbs equal
    Field._mul_plain's."""
    monkeypatch.setattr(cuda, "_stream", lambda: None)
    monkeypatch.setattr(cuda, "_require", lambda *a, **k: None)
    rng = np.random.default_rng(SEED + 1)
    for curve in ("BN254", "BLS12381", "BN158"):
        F = Field(get_curve(curve).fp, "cpu")
        L = F.L
        fake = _FakeK1(F, L)
        asked = []

        def lib(source, limbs=cuda.BASE_L, fake=fake):
            asked.append((source, limbs))
            return fake

        monkeypatch.setattr(cuda, "_lib", lib)
        below = cuda.K1_TEAM_BELOW[L]
        a, b, _, _ = _operands(F, curve, below, rng)
        key = cuda.kernel_key("mont_mul", L)
        for lanes, entry in ((below - 1, "kzg_mont_mul_team"),
                             (below, "kzg_mont_mul")):
            before = cuda.counts()
            shapes = cuda.KERNELS[key].shapes[lanes]
            x, y = a[:, :lanes].contiguous(), b[:, :lanes].contiguous()
            got = cuda.mont_mul(F, x, y)
            after = cuda.counts()
            assert fake.calls[-1] == (entry, L)
            assert asked[-1] == ("mont_mul", L)
            assert {k: after[k] - before[k] for k in after
                    if after[k] != before[k]} == {key: 1}
            assert cuda.KERNELS[key].shapes[lanes] == shapes + 1
            assert torch.equal(got, F._mul_plain(x, y))
        assert cuda.k1_grid(L, below - 1)[1] == 32 * k1_team.LAYOUT[L][1]
        assert cuda.k1_grid(L, below) == (-(-below // 128), 128)
