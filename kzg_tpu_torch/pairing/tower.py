"""Batched Fp12 arithmetic as a flat degree-6 extension of Fp2 (counterpart
of kzg_tpu/pairing/tower.py).

Since s^2 = v and v^3 = xi, Fp12 = Fp6[s]/(s^2 - v) collapses to
Fp12 = Fp2[s]/(s^6 - xi). An element is the tensor of its six Fp2
coefficients with the coefficient index as a trailing batch axis:
shape (2, L, *batch, 6). Multiplication is one broadcast Fp2 multiply of all
36 coefficient pairs, a skew-reshape anti-diagonal sum, and one xi-fold.

Flat coefficient order matches refmodel.model.Tower.e12_coeffs:
(a0, b0, a1, b1, a2, b2) = coefficients of s^0..s^5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from ..fields.quadratic import Fp2


class Fp12Ops:
    def __init__(self, f2: Fp2, xi):
        self.f2 = f2
        p = f2.base.modulus
        self.xi_c = f2.encode([(xi[0] % p, xi[1] % p)])[..., 0]   # (2, L)

    # -- construction ----------------------------------------------------
    def zero(self, batch=()):
        return self.f2.zeros((*batch, 6))

    def one(self, batch=()):
        o = self.zero(batch)
        o[..., 0] = self.f2.ones(batch)
        return o

    # -- ring ops ---------------------------------------------------------
    def _xi_mul(self, x):
        c = self.xi_c.reshape(self.xi_c.shape[:2] + (1,) * (x.ndim - 2))
        return self.f2.mul(x, c.expand(x.shape))

    def _fold(self, c11):
        """11-coefficient product -> 6 coefficients via s^6 = xi."""
        hi = self._xi_mul(c11[..., 6:])                   # 5 coeffs
        return c11[..., :6] + nnf.pad(hi, (0, 1))

    def mul(self, a, b):
        """Full 6x6 coefficient product in ONE broadcast Fp2 mul, then the
        anti-diagonal skew sum and xi-fold (outputs stay lazy: limbs < 2^19,
        value < ~36p, inside every consumer's input contract)."""
        P = self.f2.mul(a[..., :, None], b[..., None, :])  # (2,L,*b,6,6)
        Pp = nnf.pad(P, (0, 6))
        flat = Pp.reshape(P.shape[:-2] + (6 * 12,))[..., : 6 * 11]
        skew = flat.reshape(P.shape[:-2] + (6, 11))
        return self._fold(skew.sum(dim=-2))

    def sqr(self, a):
        return self.mul(a, a)

    def mul_sparse(self, f, terms):
        """f * sum_k c_k s^(pos_k) for sparse terms [(pos, c2), ...];
        c2 shaped (2, L, *batch). All terms multiply in ONE broadcast Fp2
        mul; the static s-position shifts land in an 11-slot accumulator
        folded once by s^6 = xi."""
        cs = torch.stack([c for _, c in terms], dim=-1)   # (2, L, *b, k)
        prod = self.f2.mul(f[..., None], cs[..., None, :])  # (2, L, *b, 6, k)
        acc = None
        for i, (pos, _) in enumerate(terms):
            sh = nnf.pad(prod[..., i], (pos, 5 - pos))
            acc = sh if acc is None else acc + sh
        return self._fold(acc)

    def conj_s(self, a):
        """a^(p^6): s -> -s (negate odd coefficients)."""
        ev = a[..., 0::2]
        od = self.f2.neg(a[..., 1::2], k=64)
        return torch.stack([ev, od], dim=-1).reshape(a.shape)

    def frob(self, a, gamma_c):
        """a^p: conjugate every Fp2 coefficient, multiply coeff k by
        gamma_c[..., k] (gamma[0] = 1, gamma[k] = xi^(k (p-1)/6))."""
        ac = self.f2.conj(a, k=64)
        g = gamma_c.reshape(gamma_c.shape[:2] + (1,) * (a.ndim - 3) + (6,))
        return self.f2.mul(ac, g.expand(a.shape))

    # -- predicates -------------------------------------------------------
    def eq(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return torch.all(self.f2.eq(a, b), dim=-1)

    def select(self, mask, a, b):
        # extra trailing axis aligns the mask against the s-coefficient axis
        return self.f2.select(torch.as_tensor(mask)[..., None], a, b)
