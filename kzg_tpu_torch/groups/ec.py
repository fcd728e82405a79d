"""Batched *complete* short-Weierstrass (a=0) group ops, generic over field
(counterpart of kzg_tpu/groups/ec.py).

One implementation covers G1 (field = fields.mont.Field over Fp) and G2
(field = fields.quadratic.Fp2). Points are dicts of homogeneous projective
coordinates ``x, y, z`` (infinity = (0 : 1 : 0)); addition and doubling use
the complete formulas of Renes–Costello–Batina (eprint 2015/1060, Algorithms
7 and 9 for j-invariant 0), correct for all inputs — equal points,
negatives, infinity — with no per-lane case analysis.

On the card, ``add``/``add_f`` launch kernel K2 (G1) or K4 (G2) and
``dbl``/``dbl_f`` launch kernel K3 (G1) or K5 (G2) (ops.cuda); on the CPU
they run ``_add_plain`` / ``_dbl_plain``, the same formulas over
``Field.mul`` / ``Fp2.mul``, which the kernels are held against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.mont import limbs_to_ints
from ..fields.quadratic import Fp2
from ..ops import cuda

COORDS = ("x", "y", "z")


class Curve:
    def __init__(self, field, b3, name=""):
        """b3 = 3*b — python int for G1, (c0, c1) int pair for G2."""
        self.F = field
        self.name = name
        self.is_fp2 = isinstance(field, Fp2)
        if self.is_fp2:
            base = field.base
            self._b3 = field.encode([tuple(c % base.modulus for c in b3)])
            self._b3 = self._b3[..., 0]        # (2, L)
        else:
            self._b3_int = b3 % field.modulus

    # ------------------------------------------------------------------
    def _mul_b3(self, t):
        if self.is_fp2:
            b3 = self._b3.reshape(self._b3.shape[:2] + (1,) * (t.ndim - 2))
            return self.F.mul(t, b3.expand(t.shape))
        return self.F.mul_const(t, self._b3_int)

    def _batch_shape(self, coord):
        return tuple(coord.shape[2:] if self.is_fp2 else coord.shape[1:])

    def _kernel_device(self, P):
        """True when this op runs on the card (its kernel); False for the
        plain version on the CPU; raises for other devices."""
        dev = P["x"].device.type
        if dev == "cuda":
            return True
        if dev != "cpu":
            raise RuntimeError(f"{self.name}: unsupported device {dev}")
        return False

    # ------------------------------------------------------------------
    # constructors / host-side conversion
    # ------------------------------------------------------------------
    def infinity(self, batch_shape=()):
        F = self.F
        return {"x": F.zeros(batch_shape), "y": F.ones(batch_shape),
                "z": F.zeros(batch_shape)}

    def from_affine(self, x, y, inf_mask=None):
        F = self.F
        batch = self._batch_shape(x)
        z = F.ones(batch)
        if inf_mask is not None:
            z = F.select(inf_mask, F.zeros(batch), z)
            y = F.select(inf_mask, F.ones(batch), y)
            x = F.select(inf_mask, F.zeros(batch), x)
        return {"x": x, "y": y, "z": z}

    def encode_points(self, pts):
        """Host: list of affine int points (None = infinity) -> batch."""
        F = self.F
        zero = (0, 0) if self.is_fp2 else 0
        xs = [zero if p is None else p[0] for p in pts]
        ys = [zero if p is None else p[1] for p in pts]
        inf = torch.tensor([p is None for p in pts], dtype=torch.bool,
                           device=F.device)
        return self.from_affine(F.encode(xs), F.encode(ys), inf)

    def decode_points(self, P):
        """Batch -> list of affine int points (None = infinity)."""
        return self.unpack_affine(self.affine_packed(P))

    # ------------------------------------------------------------------
    # complete group law (RCB15 Alg 7 / Alg 9, a = 0)
    # ------------------------------------------------------------------
    def add(self, P, Q, reset=None):
        """Complete add; with a bool `reset` mask (batch shape) the lanes
        where it is set return Q instead: select(reset, Q, P + Q), the
        running-sum step of the chunked bucket scan. K2 (G1) or K4 (G2) on
        the card."""
        if self._kernel_device(P):
            add = cuda.g2_add if self.is_fp2 else cuda.g1_add
            return add(self, P, Q, reset)
        out = self._add_plain(P, Q)
        if reset is not None:
            out = self.select(reset, Q, out)
        return out

    add_f = add

    def _add_plain(self, P, Q):
        """Independent products stacked into two batched mul rounds."""
        F = self.F
        X1, Y1, Z1 = P["x"], P["y"], P["z"]
        X2, Y2, Z2 = Q["x"], Q["y"], Q["z"]
        t0, t1, t2, tA, tB, tC = F.mul_many([
            (X1, X2), (Y1, Y2), (Z1, Z2),
            (F.add(X1, Y1), F.add(X2, Y2)),
            (F.add(Y1, Z1), F.add(Y2, Z2)),
            (F.add(X1, Z1), F.add(X2, Z2))])
        t3 = F.sub(tA, F.add(t0, t1), k=16)              # X1Y2 + X2Y1
        t4 = F.sub(tB, F.add(t1, t2), k=16)              # Y1Z2 + Y2Z1
        t5 = F.sub(tC, F.add(t0, t2), k=16)              # X1Z2 + X2Z1
        Ft = self._mul_b3(t2)                           # 3b Z1Z2
        Zt = F.add(t1, Ft)                              # Y1Y2 + 3bZ1Z2
        M = F.sub(t1, Ft, k=16)                         # Y1Y2 - 3bZ1Z2
        G = self._mul_b3(t5)                            # 3b (X1Z2+X2Z1)
        t0_3 = F.mul_small(t0, 3)                       # 3 X1X2
        X3a, X3b, Y3a, Y3b, Z3a, Z3b = F.mul_many([
            (t3, M), (t4, G), (M, Zt), (t0_3, G), (t4, Zt), (t3, t0_3)])
        X3 = F.sub(X3a, X3b, k=16)
        Y3 = F.add(Y3a, Y3b)
        Z3 = F.add(Z3a, Z3b)
        return {"x": X3, "y": Y3, "z": Z3}

    def dbl(self, P):
        return self.dbl_f(P, 1)

    def dbl_f(self, P, times: int = 1):
        """`times` chained doublings; one K3 (G1) or K5 (G2) launch on the
        card (times = 0 returns P, as the plain loop does)."""
        if times > 0 and self._kernel_device(P):
            dbl = cuda.g2_dbl if self.is_fp2 else cuda.g1_dbl
            return dbl(self, P, times)
        for _ in range(times):
            P = self._dbl_plain(P)
        return P

    def _dbl_plain(self, P):
        F = self.F
        X, Y, Z = P["x"], P["y"], P["z"]
        t0, t1, zz, xy = F.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        e8 = F.mul_small(t0, 8)                         # 8 Y^2
        t2 = self._mul_b3(zz)                           # 3b Z^2
        Y3t = F.add(t0, t2)                             # Y^2 + 3bZ^2
        # 9b Z^2 is the b-arg of the lazy sub below (limb budget 2^20-16);
        # a G1 curve with 9b > 15 spends one full constant mul to get fresh
        # 16-bit limbs. Fp2 (G2) keeps the small-scale path: its subs are
        # exact and 9b*1.1 <= 32 holds for the derived twists.
        if not self.is_fp2 and 3 * self._b3_int > 15:
            c9 = F.const(3 * self._b3_int, ()).reshape(
                (F.L,) + (1,) * (zz.ndim - 1))
            X3, Z3, t2_9 = F.mul_many([(t2, e8), (t1, e8),
                                       (zz, c9.expand(zz.shape))])
        else:
            X3, Z3 = F.mul_many([(t2, e8), (t1, e8)])
            t2_9 = F.mul_small(t2, 3)
        t0 = F.sub(t0, t2_9, k=32)                      # Y^2 - 9bZ^2
        Ya, Xa = F.mul_many([(t0, Y3t), (t0, xy)])
        Y3 = F.add(Ya, X3)
        X3 = F.mul_small(Xa, 2)
        return {"x": X3, "y": Y3, "z": Z3}

    def neg(self, P):
        return {"x": P["x"], "y": self.F.neg(P["y"], 8), "z": P["z"]}

    def select(self, mask, P, Q):
        sel = self.F.select
        return {k: sel(mask, P[k], Q[k]) for k in COORDS}

    # ------------------------------------------------------------------
    # conversions / predicates (boundary ops — exact)
    # ------------------------------------------------------------------
    def is_inf(self, P):
        return self.F.is_zero(P["z"])

    def to_affine(self, P):
        """-> (x_affine, y_affine, inf_mask); infinity lanes give (0, 0)."""
        F = self.F
        if self._batch_shape(P["z"]):
            zi = F.batch_inv(P["z"])           # 0 lanes -> 0
        else:
            zi = F.inv(P["z"])
        x, y = F.mul_many([(P["x"], zi), (P["y"], zi)])
        inf = self.is_inf(P)
        zero = F.zeros(self._batch_shape(x))
        return (F.select(inf, zero, x), F.select(inf, zero, y), inf)

    def affine_packed(self, P):
        """Projective batch -> packed canonical affine int64 tensor
        (C*2*L + 1, *batch): x limbs, y limbs, infinity flag (C = 1 for
        Fp, 2 for Fp2) — the layout of the JAX package's Curve.affine_packed."""
        x, y, inf = self.to_affine(P)
        F = self.F
        if self.is_fp2:
            xr = F.canon(F.from_mont(x))
            yr = F.canon(F.from_mont(y))
            xr = xr.reshape((-1,) + xr.shape[2:])
            yr = yr.reshape((-1,) + yr.shape[2:])
        else:
            xy = F.canon(F.from_mont(torch.stack([x, y], dim=1)))
            xr, yr = xy[:, 0], xy[:, 1]
        return torch.cat([xr, yr, inf[None].to(torch.int64)], dim=0)

    def unpack_affine(self, arr):
        """Host: packed-affine array (C*2*L+1, *batch) -> list of affine int
        points (None = infinity)."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr).reshape(arr.shape[0], -1)
        L = (a.shape[0] - 1) // (4 if self.is_fp2 else 2)

        def to_list(v):
            out = limbs_to_ints(v)
            return out if isinstance(out, list) else [out]

        if self.is_fp2:
            xs = list(zip(to_list(a[:L]), to_list(a[L:2 * L])))
            ys = list(zip(to_list(a[2 * L:3 * L]), to_list(a[3 * L:4 * L])))
        else:
            xs, ys = to_list(a[:L]), to_list(a[L:2 * L])
        inf = a[-1] != 0
        return [None if i else (x, y) for x, y, i in zip(xs, ys, inf)]

    def eq(self, P, Q):
        """Exact equality as group elements (cross-multiplied)."""
        F = self.F
        xa, xb, ya, yb = F.mul_many([(P["x"], Q["z"]), (Q["x"], P["z"]),
                                     (P["y"], Q["z"]), (Q["y"], P["z"])])
        both_fin = torch.logical_and(F.eq(xa, xb), F.eq(ya, yb))
        pi, qi = self.is_inf(P), self.is_inf(Q)
        return torch.where(torch.logical_or(pi, qi),
                           torch.logical_and(pi, qi), both_fin)

    # ------------------------------------------------------------------
    # fixed-base comb: window tables + digit-gather multiplication
    # ------------------------------------------------------------------
    def window_table(self, dbl_table, n_windows: int, wbits: int = 8):
        """Doubling table (leading axis j: 2^j G) -> comb table with batch
        (n_windows, 2^wbits): entry [w, d] = d * 2^(wbits*w) * G.
        2^wbits - 1 sequential adds over n_windows lanes."""
        idx = torch.arange(n_windows, device=self.F.device) * wbits
        S = {k: torch.movedim(v[idx], 0, -1) for k, v in dbl_table.items()}
        inf = self.infinity((n_windows,))
        rows = [inf]
        acc = inf
        for _ in range((1 << wbits) - 1):
            acc = self.add(acc, S)
            rows.append(acc)
        return {k: torch.stack([r[k] for r in rows], dim=-1)
                for k in COORDS}                        # batch (W, 256)

    def mul_digits_table(self, digits, wtab):
        """sum_w digits[w, i] * 2^(8w) G for each i, via the comb table.

        digits: int (W, n) byte digits; wtab: window_table output with batch
        (W, 256). One packed flat gather (W*n rows) + a log2(W) pairwise
        tree of complete adds."""
        W, n = digits.shape
        flat = (torch.arange(W, device=digits.device)[:, None] * 256
                + digits.to(torch.int64)).reshape(-1)
        P = {}
        for k in COORDS:
            v = wtab[k]
            lead = v.shape[:-2]
            g = v.reshape(lead + (W * 256,))[..., flat]
            P[k] = g.reshape(lead + (W, n))
        m = W
        while m > 1:
            half = (m + 1) // 2
            A = {k: v[..., :m - half, :] for k, v in P.items()}
            B = {k: v[..., half:m, :] for k, v in P.items()}
            top = {k: v[..., m - half:half, :] for k, v in P.items()}
            S = self.add(A, B)
            P = {k: torch.cat([S[k], top[k]], dim=-2) for k in COORDS}
            m = half
        return {k: v[..., 0, :] for k, v in P.items()}
