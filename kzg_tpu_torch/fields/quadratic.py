"""Fp2 arithmetic layered on the batched base field (counterpart of
kzg_tpu/fields/quadratic.py).

Element representation: ``int64[2, L, *batch]`` — component axis first
(c0 + c1*w, w^2 = qnr), then the base field's limb-major layout. Exposes the
operation surface of fields.mont.Field so the group law in groups.ec works
over either field (G1 over Fp, G2 over Fp2). Every product goes through
``Field.mul`` (kernel K1 on the card).
"""

from __future__ import annotations

import torch

from .mont import Field


class Fp2:
    def __init__(self, base: Field, qnr: int):
        self.base = base
        self.device = base.device
        self.qnr = qnr % base.modulus
        # -1 is the common case (p = 3 mod 4); mul-by-qnr is then a sub
        self.qnr_is_m1 = (self.qnr == base.modulus - 1)
        if not self.qnr_is_m1:
            self.qnr_small = self.qnr if self.qnr < 16 else None
            if self.qnr_small is None:
                raise NotImplementedError(
                    "qnr must be -1 or small (<16); derived curves satisfy this")
        B = base
        # per-row exact-sub slack of mul's output subtraction (2p for c0, 4p
        # for c1), shaped (L, 2) for the stacked chain
        self._kp24 = torch.stack([B._kp_limbs(2), B._kp_limbs(4)], dim=1)

    # -- shape helpers ---------------------------------------------------
    def zeros(self, batch_shape=()):
        return torch.stack([self.base.zeros(batch_shape)] * 2, dim=0)

    def ones(self, batch_shape=()):
        return torch.stack([self.base.ones(batch_shape),
                            self.base.zeros(batch_shape)], dim=0)

    def encode(self, pairs):
        """[(c0, c1) python ints] -> (2, L, n)."""
        pairs = list(pairs)
        return torch.stack([self.base.encode([a for a, _ in pairs]),
                            self.base.encode([b for _, b in pairs])], dim=0)

    def decode(self, arr):
        c0 = self.base.decode(arr[0])
        c1 = self.base.decode(arr[1])
        if isinstance(c0, list):
            return list(zip(c0, c1))
        return (c0, c1)

    # -- component stacking ----------------------------------------------
    # Every componentwise Fp2 op folds the component axis into the base
    # batch ((2, L, *b) -> (L, 2, *b)) and runs ONE base op instead of two.
    @staticmethod
    def _cstack(a):
        return torch.movedim(a, 0, 1)

    @staticmethod
    def _cunstack(s):
        return torch.movedim(s, 1, 0)

    def _bc2(self, a, b):
        """Broadcast two (2, L, *batch) tensors over their batch dims."""
        if a.shape == b.shape:
            return a, b
        nd = max(a.ndim, b.ndim)
        a = a.reshape(a.shape[:2] + (1,) * (nd - a.ndim) + a.shape[2:])
        b = b.reshape(b.shape[:2] + (1,) * (nd - b.ndim) + b.shape[2:])
        return torch.broadcast_tensors(a, b)

    # -- ring ops --------------------------------------------------------
    def add(self, a, b):
        a, b = self._bc2(a, b)
        return a + b

    # Fp2 subs stay on the exact path (lazy=False): the pairing tower's
    # add/fold/conjugate chains are value-calibrated against sub's tight
    # k*p slack; the lazy path's m*p slack would overflow those budgets.
    def sub(self, a, b, k: int = 16):
        a, b = self._bc2(a, b)
        return self._cunstack(self.base.sub(
            self._cstack(a), self._cstack(b), k, lazy=False))

    def neg(self, a, k: int = 16):
        return self._cunstack(self.base.neg(self._cstack(a), k, lazy=False))

    def conj(self, a, k: int = 16):
        return torch.stack([a[0], self.base.neg(a[1], k, lazy=False)], dim=0)

    def _mul_qnr(self, x):
        """qnr * x in the base field."""
        if self.qnr_is_m1:
            return self.base.neg(x, lazy=False)
        return self.base.mul_small(x, self.qnr_small)

    def mul(self, a, b):
        """Karatsuba; components of the result are <= 5.6p. The three base
        products (v0, v1, cross) run as ONE stacked base mul, and the two
        output subtractions as one stacked exact-sub chain with per-row
        slack constants (2p for c0, 4p for c1)."""
        B = self.base
        a, b = self._bc2(a, b)
        A = torch.stack([a[0], a[1], a[0] + a[1]], dim=1)
        Bv = torch.stack([b[0], b[1], b[0] + b[1]], dim=1)
        P = B.mul(A, Bv)                     # (L, 3, *batch)
        v0, v1, t = P[:, 0], P[:, 1], P[:, 2]
        if self.qnr_is_m1:
            lhs = torch.stack([v0, t], dim=1)
            rhs = torch.stack([v1, v0 + v1], dim=1)
            kp = self._kp24.reshape(self._kp24.shape + (1,) * (lhs.ndim - 2))
            tn = B._norm16(lhs + kp)
            bn = B._norm16(rhs)
            d, _ = B._sub_chain([tn[i] for i in range(B.L)],
                                [bn[i] for i in range(B.L)])
            d = torch.stack(d, dim=0)
            return torch.stack([d[:, 0], d[:, 1]], dim=0)
        c0 = B.add(v0, self._mul_qnr(v1))
        c1 = B.sub(t, B.add(v0, v1), k=4, lazy=False)
        return torch.stack([c0, c1], dim=0)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_many(self, pairs):
        """Stacked batch of independent Fp2 products (see Field.mul_many).
        Pairs may have different (broadcastable) batch shapes — e.g. a curve
        constant against a point batch."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        bc = [self._bc2(a, b) for a, b in pairs]
        shape = torch.broadcast_shapes(*[p[0].shape for p in bc])
        a = torch.stack([p[0].expand(shape) for p in bc], dim=2)
        b = torch.stack([p[1].expand(shape) for p in bc], dim=2)
        out = self.mul(a, b)
        return [out[:, :, i] for i in range(len(pairs))]

    def mul_small(self, a, k: int):
        return a * k

    def freshen(self, a):
        return self._cunstack(self.base.freshen(self._cstack(a)))

    def mul_base(self, a, c):
        """Multiply Fp2 element by a base-field element c (limb tensor) —
        one stacked base mul (c broadcast over the component axis)."""
        return self._cunstack(self.base.mul(self._cstack(a), c[:, None]))

    # -- domain conversion -------------------------------------------------
    def from_mont(self, a):
        return self._cunstack(self.base.from_mont(self._cstack(a)))

    def canon(self, a, max_subs: int = 2):
        return self._cunstack(self.base.canon(self._cstack(a), max_subs))

    # -- predicates ------------------------------------------------------
    def is_zero(self, a):
        return torch.all(self.base.is_zero(self._cstack(a)), dim=0)

    def eq(self, a, b):
        a, b = self._bc2(a, b)
        return torch.all(self.base.eq(self._cstack(a), self._cstack(b)),
                         dim=0)

    def select(self, mask, a, b):
        mask = torch.as_tensor(mask, device=a.device)
        a, b = self._bc2(a, b)
        return torch.where(mask[None, None], a, b)

    # -- inversion -------------------------------------------------------
    def _norm_val(self, a):
        """a0^2 - qnr a1^2 (the Fp2 norm), base-field element."""
        B = self.base
        s = B.sqr(self._cstack(a))           # both component squares at once
        t0, t1 = s[:, 0], s[:, 1]
        if self.qnr_is_m1:
            return B.add(t0, t1)
        return B.sub(t0, B.mul_small(t1, self.qnr_small), k=32, lazy=False)

    def inv(self, a):
        B = self.base
        d = B.inv(self._norm_val(a))
        return torch.stack([B.mul(a[0], d),
                            B.neg(B.mul(a[1], d), lazy=False)], dim=0)

    def batch_inv(self, a, axis=1):
        """axis counts batch axes of the *component* layout (>=1 past limbs),
        i.e. a has shape (2, L, *batch) and axis refers to (L, *batch)."""
        B = self.base
        d = B.batch_inv(self._norm_val(a), axis=axis)
        return torch.stack([B.mul(a[0], d),
                            B.neg(B.mul(a[1], d), lazy=False)], dim=0)
