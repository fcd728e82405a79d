"""Batched Montgomery big-field arithmetic on torch tensors (counterpart of
kzg_tpu/fields/mont.py).

Representation (the JAX package's, so the same numpy limbs feed both):
  * a field element batch is ``int64[L, *batch]`` — limb-major, little-endian
    base-2^16 limbs in the Montgomery domain with R = 2^(16 L); the limb
    count leaves R >= 2^16 p of headroom for *lazy* arithmetic: limbs may
    exceed 16 bits and values may exceed p between operations; nothing
    canonicalizes until a boundary (equality, digit extraction,
    serialization) calls :meth:`canon`;
  * limbs are int64 because torch's uint32 lacks shifts on the CPU. Every
    value stays non-negative (the lifted ``sub`` keeps it so), so arithmetic
    ``>>`` is a logical shift.

Value-bound discipline (the JAX package's contract, and what holds):
  * mul: the JAX package states inputs value < 64 p, limbs < 2^22, and
    outputs with exact 16-bit limbs, value < 1.1 p. The product itself
    needs only limbs < 2^22 (and a value below R); its output is then
    (a b + m p) / R < a b / R + p: < 1.1 p for inputs below 64 p (R >=
    2^16 p), < 2 p while a b < R p. The G1 complete add's lazy
    subtractions add lift_limbs(16)'s m p (m = 180 on BN254, 247 on
    BLS12-381), so it gives Field.mul inputs past 64 p: on BN254 up to
    ~1082 p with a b < 0.44 R p; on BLS12-381 (L = 25, R > 645,173 p)
    G = 3b (X1Z2 + X2Z1) up to ~2976 p (limbs up to ~843,000) times ~248 p,
    a b up to 1.14 R p, so that product's output reaches ~2.14 p (measured
    by tests/test_torch_g2_schedule.py, which holds the lane-team schedules
    to a b < 1.15 R p there, output < 2.15 p). Its callers take such an
    output as a lazy value; kernels and plain versions agree limb for
    limb on it, and the add's outputs re-reduce below 1.1 p. On BN158
    (L = 11, R > 466,000 p, lift m = 185) the G1 add's 3b = 39 is a full
    product, so its widest inputs are ~186 p with a b < 0.08 R p, and
    the G2 formulas over Fp2 with qnr = 5 (a lazy c0 = v0 + 5 v1) give
    inputs up to ~66 p, past 64 p, with limbs below 2^22 and a b below
    0.01 R p;
  * add is lazy (1 op), bounds add;  sub(a, b) requires value(b) <= k p and
    emits limbs <= 2^16 + 1 with value <= value(a) + m p (see _kp_lift).

``Field.mul`` is the wrapper of kernel K1 (csrc/mont_mul.cu): a tensor on
the card launches the kernel, a tensor on the CPU runs ``_mul_plain``, the
int64 schoolbook product plus word-by-word Montgomery reduction that the
kernel is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.params import FieldParams, LIMB_BITS, LIMB_MASK
from ..ops import cuda

I64 = torch.int64


def ints_to_limbs(values, n_limbs: int) -> np.ndarray:
    """Host-side: iterable of python ints -> uint32[n_limbs, len] (limb-major)."""
    values = list(values)
    nbytes = 2 * n_limbs
    mask = (1 << (LIMB_BITS * n_limbs)) - 1
    buf = b"".join((int(v) & mask).to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(
        len(values), n_limbs).T.astype(np.uint32)


def limbs_to_ints(arr):
    """Host-side: [n_limbs, *batch] limbs (numpy or tensor) -> nested lists of
    python ints (a single int for a 1-D input)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr).astype(np.uint64)
    L = a.shape[0]
    flat = a.reshape(L, -1)
    n = flat.shape[1]
    if flat.size == 0:
        vals = []
    elif flat.max() <= LIMB_MASK:
        b = np.ascontiguousarray(flat.T).astype("<u2").tobytes()
        w = 2 * L
        vals = [int.from_bytes(b[i * w:(i + 1) * w], "little")
                for i in range(n)]
    else:                       # lazy (un-canonicalized) limbs: exact path
        vals = [sum(int(flat[j, i]) << (LIMB_BITS * j) for j in range(L))
                for i in range(n)]
    if a.ndim == 1:
        return vals[0]
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out.reshape(a.shape[1:]).tolist()


def _shift_up(x):
    """x[i] -> position i+1 along the limb axis (zero into limb 0, top
    dropped)."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


class Field:
    """Arithmetic mod a fixed prime over int64[L, *batch] limb tensors on one
    device."""

    def __init__(self, fp: FieldParams, device="cpu"):
        self.params = fp
        self.device = torch.device(device)
        self.L = L = fp.n_limbs
        self.modulus = fp.modulus
        # -p^-1 mod 2^16: the per-digit Montgomery factor of K1 and the plain
        # reduction (the low limb of the full-width pprime)
        self.n0 = fp.pprime & LIMB_MASK
        self.p_list = list(fp.limbs)
        self.p_limbs = self._t(fp.limbs)
        self.r2_limbs = self._t(fp.r2_limbs)
        self.one_mont = self._t(fp.one_limbs)          # R mod p
        self._kp_cache = {}
        self._lift_cache = {}
        self._const_cache = {}

    def _t(self, limbs):
        return torch.tensor([int(v) for v in limbs], dtype=I64,
                            device=self.device)

    def _col(self, limbs, batch_ndim):
        """(L,) constant -> (L, 1, 1, ...) for broadcasting."""
        return limbs.reshape((-1,) + (1,) * batch_ndim)

    def _kp_limbs(self, k: int):
        """k*p as canonical 16-bit limbs (k static, k*p < R asserted)."""
        if k not in self._kp_cache:
            v = k * self.modulus
            assert v >> (LIMB_BITS * self.L) == 0, \
                f"k={k}: k*p exceeds R — limb headroom violated"
            self._kp_cache[k] = self._t(
                [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.L)])
        return self._kp_cache[k]

    # Lazy-subtract lift: 2^20 added to every non-top limb of a multiple of
    # p, borrowed back from the limb above (value unchanged). 2^20 covers
    # every b-limb pattern the lazy callers produce (fresh muls <= 2^16.01,
    # short add chains <= 2^18, mul_small by <= 15 of fresh <= 2^19.9).
    LIFT = 1 << 20
    _LIFT_BORROW = LIFT >> LIMB_BITS                       # 16

    def lift_limbs(self, k: int):
        """Limb-lifted representation of m*p for the smallest m >= k whose
        top limb can absorb the lift borrow plus b's top limb. Returns
        (python int list of L limbs, m); every non-top limb is in
        [2^20-16, 2^20+2^16), so per-limb subtraction of any lazy-caller b
        never goes negative."""
        if k not in self._lift_cache:
            L, LB = self.L, LIMB_BITS
            R = 1 << (LB * L)
            b_top = (k * self.modulus << LB) // R
            need = self._LIFT_BORROW + b_top + 8           # +8 safety margin
            m = k
            while True:
                v = m * self.modulus
                assert v < R, f"k={k}: no liftable multiple of p below R"
                if (v >> (LB * (L - 1))) >= need:
                    break
                m += 1
            limbs = [(v >> (LB * i)) & LIMB_MASK for i in range(L)]
            c = ([limbs[0] + self.LIFT]
                 + [limbs[i] + self.LIFT - self._LIFT_BORROW
                    for i in range(1, L - 1)]
                 + [limbs[L - 1] - self._LIFT_BORROW])
            self._lift_cache[k] = (c, m, self._t(c))
        c, m, _ = self._lift_cache[k]
        return c, m

    def _kp_lift(self, k: int):
        self.lift_limbs(k)
        return self._lift_cache[k][2]

    # ------------------------------------------------------------------
    # shape plumbing
    # ------------------------------------------------------------------
    def _bc(self, a, b):
        """Broadcast two (L, *batch) tensors over their batch dims."""
        if a.shape == b.shape:
            return a, b
        nd = max(a.ndim, b.ndim)
        a = a.reshape(a.shape[:1] + (1,) * (nd - a.ndim) + a.shape[1:])
        b = b.reshape(b.shape[:1] + (1,) * (nd - b.ndim) + b.shape[1:])
        return torch.broadcast_tensors(a, b)

    # ------------------------------------------------------------------
    # encode / decode (host side)
    # ------------------------------------------------------------------
    def raw(self, values):
        """Python ints (reduced mod p) -> raw limb tensor (L, n), not
        Montgomery."""
        arr = ints_to_limbs([int(v) % self.modulus for v in values], self.L)
        return torch.from_numpy(arr.astype(np.int64)).to(self.device)

    def encode(self, values):
        """Python ints -> Montgomery-domain limb tensor (L, n)."""
        return self.to_mont(self.raw(values))

    def decode(self, arr):
        """Montgomery-domain limb tensor -> python ints (canonical)."""
        return limbs_to_ints(self.canon(self.from_mont(arr)))

    def zeros(self, batch_shape=()):
        return torch.zeros((self.L, *batch_shape), dtype=I64,
                           device=self.device)

    def ones(self, batch_shape=()):
        return self._col(self.one_mont, len(batch_shape)).expand(
            (self.L, *batch_shape)).clone()

    def const(self, value: int, batch_shape=()):
        """Montgomery-form constant from a python int."""
        v = int(value) % self.modulus
        if v not in self._const_cache:
            v_m = v * self.params.mont_r % self.modulus
            self._const_cache[v] = self._t(
                [(v_m >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.L)])
        c = self._const_cache[v]
        return self._col(c, len(batch_shape)).expand((self.L, *batch_shape))

    # ------------------------------------------------------------------
    # limb plumbing
    # ------------------------------------------------------------------
    def _norm16(self, x):
        """Exact carry propagation to <= 0xFFFF limbs (value must be < R)."""
        out = []
        c = None
        for i in range(self.L):
            v = x[i] if c is None else x[i] + c
            out.append(v & LIMB_MASK)
            c = v >> LIMB_BITS
        return torch.stack(out, dim=0)

    def _sub_chain(self, a_limbs, b_limbs):
        """Exact (a - b) over canonical 16-bit limb lists via one's-complement
        addition. Returns (diff list, no_borrow)."""
        out = []
        c = 1
        for ai, bi in zip(a_limbs, b_limbs):
            v = ai + (LIMB_MASK - bi) + c
            out.append(v & LIMB_MASK)
            c = v >> LIMB_BITS
        return out, c

    @staticmethod
    def _pass16(x):
        """One local 16-bit carry pass along the limb axis (inputs represent
        values < R, whose top limb is < 2^16 — no carry is dropped)."""
        return (x & LIMB_MASK) + _shift_up(x >> LIMB_BITS)

    # ------------------------------------------------------------------
    # core ops
    # ------------------------------------------------------------------
    def add(self, a, b):
        a, b = self._bc(a, b)
        return a + b

    def sub(self, a, b, k: int = 16, lazy: bool = True):
        """a - b (+m*p to stay non-negative, m = smallest liftable multiple
        >= k; see lift_limbs). Contracts (lazy path, the default):
          value(b) <= k*p; limbs(b) <= 2^20-16; limbs(a) <= 2^21;
          value(a) + m*p < R.
        Output: limbs <= 2^16+1, value <= value(a) + m*p. The exact path
        (lazy=False, used by the Fp2/pairing tower) emits exact 16-bit limbs
        with value <= value(a) + k*p."""
        a, b = self._bc(a, b)
        if not lazy:
            t = self._norm16(a + self._col(self._kp_limbs(k), a.ndim - 1))
            bn = self._norm16(b)
            d, _ = self._sub_chain([t[i] for i in range(self.L)],
                                   [bn[i] for i in range(self.L)])
            return torch.stack(d, dim=0)
        d = a + self._col(self._kp_lift(k), a.ndim - 1) - b
        return self._pass16(self._pass16(d))

    def neg(self, a, k: int = 16, lazy: bool = True):
        return self.sub(torch.zeros_like(a), a, k, lazy)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1. Input contract: value < 64 p, limbs
        < 2^22. Output: exact 16-bit limbs, value < 1.1 p (below a b / R +
        p in general; see the module docstring for the inputs past 64 p that
        the G1 add gives it). Kernel K1 on the card (at the field's limb
        count), _mul_plain on the CPU."""
        a, b = self._bc(a, b)
        if a.device.type == "cuda":
            return cuda.mont_mul(self, a, b)
        if a.device.type != "cpu":
            raise RuntimeError(f"Field.mul: unsupported device {a.device}")
        return self._mul_plain(a, b)

    def _mul_plain(self, a, b):
        """Plain version of K1: int64 schoolbook product columns, then L
        rounds of base-2^16 Montgomery reduction (m = t_i * n0 mod 2^16,
        t += m p 2^(16 i)), then exact normalization of the high half.
        Columns stay below 2^50 for inputs within the contract."""
        L = self.L
        T = torch.zeros((2 * L + 1,) + a.shape[1:], dtype=I64,
                        device=a.device)
        for i in range(L):
            T[i:i + L] += a[i] * b
        p = self._col(self.p_limbs, a.ndim - 1)
        for i in range(L):
            m = ((T[i] & LIMB_MASK) * self.n0) & LIMB_MASK
            T[i:i + L] += m * p
            T[i + 1] += T[i] >> LIMB_BITS
        return self._norm16(T[L:2 * L])

    def sqr(self, a):
        return self.mul(a, a)

    def mul_many(self, pairs):
        """[(a, b), ...] (same batch shape after broadcast) -> list of
        Montgomery products, computed as ONE stacked mul (one launch)."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        bc = [self._bc(a, b) for a, b in pairs]
        a = torch.stack([p[0] for p in bc], dim=1)      # (L, k, *batch)
        b = torch.stack([p[1] for p in bc], dim=1)
        out = self.mul(a, b)
        return [out[:, i] for i in range(len(pairs))]

    def freshen(self, a):
        """Identity that re-reduces value to < 1.1p (Montgomery-mul by the
        Montgomery form of 1, whose plain value is R mod p)."""
        return self.mul(a, self._col(self.one_mont, a.ndim - 1))

    def mul_small(self, a, k: int):
        """Multiply by a small non-negative int (lazy; value scales by k,
        keep k <= 16 to respect limb bounds)."""
        return a * k

    def mul_const(self, a, c: int):
        """Multiply by a fixed python-int constant: lazy scaling when small,
        full Montgomery mul by the precomputed constant otherwise."""
        c = int(c) % self.modulus
        if c <= 14:          # 14: callers subtract c-scaled values under k=16
            return self.mul_small(a, c)
        return self.mul(a, self.const(c, ()).reshape(
            (self.L,) + (1,) * (a.ndim - 1)))

    # ------------------------------------------------------------------
    # canonicalization / domain conversion
    # ------------------------------------------------------------------
    def canon(self, a, max_subs: int = 2):
        """Exact canonical form (< p, 16-bit limbs). Value must be
        < max_subs * p and limbs < 2^26."""
        n = self._norm16(a)
        out = [n[i] for i in range(self.L)]
        for _ in range(max_subs):
            d, no_borrow = self._sub_chain(out, self.p_list)
            take = no_borrow != 0
            out = [torch.where(take, di, oi) for di, oi in zip(d, out)]
        return torch.stack(out, dim=0)

    def to_mont(self, raw):
        return self.mul(raw, self._col(self.r2_limbs, raw.ndim - 1))

    def from_mont(self, a):
        one = torch.zeros_like(a)
        one[0] = 1
        return self.mul(a, one)

    # ------------------------------------------------------------------
    # predicates (exact — x -> x R^-1 mod p is a bijection)
    # ------------------------------------------------------------------
    def is_zero(self, a):
        return torch.all(self.canon(self.from_mont(a)) == 0, dim=0)

    def eq(self, a, b):
        a, b = self._bc(a, b)
        c = self.canon(self.from_mont(torch.stack([a, b], dim=1)))
        return torch.all(c[:, 0] == c[:, 1], dim=0)

    def select(self, mask, a, b):
        """mask broadcastable to batch shape; True -> a."""
        mask = torch.as_tensor(mask, device=a.device)
        a, b = self._bc(a, b)
        return torch.where(mask[None], a, b)

    # ------------------------------------------------------------------
    # inversion / exponentiation
    # ------------------------------------------------------------------
    def pow_const(self, a, e: int):
        """a^e for a fixed python-int exponent. Long exponents (inversion's
        p-2) use 4-bit windows: per digit 4 squarings + one table multiply."""
        if e == 0:
            return self.ones(a.shape[1:])
        if e.bit_length() <= 16:
            acc = a
            for i in range(e.bit_length() - 2, -1, -1):
                acc = self.sqr(acc)
                if (e >> i) & 1:
                    acc = self.mul(acc, a)
            return acc
        nd = (e.bit_length() + 3) // 4
        digs = [(e >> (4 * (nd - 1 - i))) & 0xF for i in range(nd)]
        # table a^0 .. a^15; a == 0 still yields 0^e == 0 because the top
        # digit of e is nonzero: acc starts (and stays) at 0 on zero lanes
        tab = [self.ones(a.shape[1:]), a]
        cur = self.sqr(a)
        tab.append(cur)
        for _ in range(13):
            cur = self.mul(cur, a)
            tab.append(cur)
        acc = tab[digs[0]]
        for d in digs[1:]:
            for _ in range(4):
                acc = self.sqr(acc)
            acc = self.mul(acc, tab[d])
        return acc

    def inv(self, a):
        """Fermat inverse a^(p-2); a == 0 -> 0."""
        return self.pow_const(a, self.modulus - 2)

    def _scan_mul(self, x, reverse=False):
        """Inclusive prefix (or suffix) products along batch axis 1, log-depth
        (Hillis-Steele: ceil(log2 n) full-width muls)."""
        n = x.shape[1]
        s = 1
        while s < n:
            if reverse:
                head = self.mul(x[:, :n - s], x[:, s:])
                x = torch.cat([head, x[:, n - s:]], dim=1)
            else:
                tail = self.mul(x[:, s:], x[:, :n - s])
                x = torch.cat([x[:, :s], tail], dim=1)
            s *= 2
        return x

    def batch_inv(self, a, axis=1):
        """Montgomery batch inversion along batch axis `axis` (>= 1; one
        Fermat inverse total). Zero entries invert to zero."""
        assert axis >= 1, "axis 0 is the limb axis"
        a = torch.movedim(a, axis, 1)
        z = self.is_zero(a)                                # (n, ...)
        one = self._col(self.one_mont, a.ndim - 1).expand(a.shape)
        safe = torch.where(z[None], one, a)
        prefix = self._scan_mul(safe)
        suffix = self._scan_mul(safe, reverse=True)
        total_inv = self.inv(prefix[:, -1])
        pre = torch.cat([one[:, :1], prefix[:, :-1]], dim=1)
        suf = torch.cat([suffix[:, 1:], one[:, :1]], dim=1)
        invs = self.mul(self.mul(pre, suf), total_inv.unsqueeze(1))
        invs = torch.where(z[None], torch.zeros_like(invs), invs)
        return torch.movedim(invs, 1, axis)
