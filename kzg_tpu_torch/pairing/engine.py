"""Optimal-ate pairing equality check (counterpart of
kzg_tpu/pairing/engine.py).

  * the Miller variable T stays on the sextic twist E'(Fp2) in projective
    coordinates — doubling/addition use the complete RCB formulas (no
    inversions in the loop), each fused with its line function so the two
    share multiplication rounds (one stacked Fp2 mul per round);
  * line functions are evaluated in *sparse* Fp12 form (three Fp2
    coefficients at twist-type-dependent s-positions); common Fp2/Fp6
    factors are dropped (killed by the final exponentiation);
  * the loop runs over the static bit pattern of |6u+2| (BN), computing the
    add step unconditionally and selecting by bit (branchless, batch 2);
  * the equality check needs no final exponentiation: with
    u = m_a * conj(m_b), FE(u) == 1 iff conj(u)^E == u^E for
    E = (p^6 + 1)/r; both sides run as ONE 2-lane joint base-p digit
    exponentiation against a 64-entry Frobenius-subset table.

The twist Frobenius psi (the two BN tail steps) is derived numerically at
build time from the exact tower and verified on G2 — no hand-copied
constants.
"""

from __future__ import annotations

import torch

from ..curves.params import CurveParams
from ..refmodel import model as rm
from .tower import Fp12Ops


def _bits_msb(n: int):
    return [(n >> i) & 1 for i in range(n.bit_length() - 1, -1, -1)]


class PairingEngine:
    def __init__(self, ctx):
        """ctx: kzg_tpu_torch.context.CurveContext (uses fp2, g2)."""
        cp: CurveParams = ctx.cp
        self.cp = cp
        self.ctx = ctx
        self.f2 = ctx.fp2
        self.g2 = ctx.g2
        self.t12 = Fp12Ops(ctx.fp2, cp.xi)
        p = cp.p

        # ---- loop scalar ----
        c = 6 * cp.u + 2 if cp.family == "bn" else cp.u
        self.loop_neg = c < 0
        self.loop_bits = _bits_msb(abs(c))

        # ---- Frobenius gamma table for Fp12 (coeff k *= xi^(k(p-1)/6)) ----
        tw = rm.Tower(cp)
        gammas = rm.frobenius_gammas(tw)          # xi^(k(p-1)/6), k=1..5
        self.gamma_c = self.f2.encode([(1, 0)] + gammas)   # (2, L, 6)

        # ---- twist Frobenius psi constants (derived + verified) ----
        self._orc = rm.Pairing(cp)
        cx, cy = self._derive_psi(tw)
        self.psi_cx, self.psi_cy = cx, cy
        self.psi_cx_c = self.f2.encode([cx])[..., 0]
        self.psi_cy_c = self.f2.encode([cy])[..., 0]

        # ---- joint base-p digits of E = (p^6 + 1)/r ----
        # One 6-bit subset index per exponent bit position (MSB first): row j
        # selects which of the six Frobenius powers g_i = u^(p^i) multiply in
        # after the j-th squaring (see _unity_check).
        E = (p ** 6 + 1) // cp.r
        assert E * cp.r == p ** 6 + 1, "r must divide p^6 + 1"
        digs = []
        t = E
        for _ in range(6):
            digs.append(t % p)
            t //= p
        assert t == 0
        nbit = max(d.bit_length() for d in digs)
        idx = [0] * nbit
        for i, d in enumerate(digs):
            for j in range(nbit):
                idx[nbit - 1 - j] |= ((d >> j) & 1) << i
        self.unity_idx = idx
        self._g2gen_cache = None

    # ------------------------------------------------------------------
    def _derive_psi(self, tw):
        """Find (cx, cy) with psi(x', y') = (conj(x') cx, conj(y') cy) on the
        twist satisfying untwist(psi Q) = pi(untwist Q); verified on G2."""
        orc = self._orc
        cp = self.cp
        og2 = rm.G2(cp)
        Q = og2.gen
        piU = orc.frob_g2(orc.untwist(Q), 1)
        tgt = self._untwist_inv(tw, piU)
        cx = tw.e2_mul(tgt[0], tw.e2_inv(tw.e2_conj(Q[0])))
        cy = tw.e2_mul(tgt[1], tw.e2_inv(tw.e2_conj(Q[1])))
        Q2 = og2.mul(987654321, og2.gen)
        t2 = self._untwist_inv(tw, orc.frob_g2(orc.untwist(Q2), 1))
        if t2[0] != tw.e2_mul(tw.e2_conj(Q2[0]), cx) or \
                t2[1] != tw.e2_mul(tw.e2_conj(Q2[1]), cy):
            raise RuntimeError("twist Frobenius psi derivation failed")
        return cx, cy

    def _untwist_inv(self, tw, U12):
        """Invert the untwist map: Fp12 point -> twist (Fp2) point."""
        orc = self._orc
        xs = tw.e12_mul(U12[0], tw.e12_inv(orc.s2))
        ys = tw.e12_mul(U12[1], tw.e12_inv(orc.s3))
        cx = tw.e12_coeffs(xs)
        cyc = tw.e12_coeffs(ys)
        if any(c != (0, 0) for c in cx[1:] + cyc[1:]):
            raise RuntimeError("untwist inverse is not an Fp2 scalar")
        return (cx[0], cyc[0])

    # ------------------------------------------------------------------
    # psi on twist points (projective; Z is Fp2 too)
    # ------------------------------------------------------------------
    def _psi(self, Q):
        F2 = self.f2
        cxx = self.psi_cx_c.reshape(
            self.psi_cx_c.shape[:2] + (1,) * (Q["x"].ndim - 2))
        cyy = self.psi_cy_c.reshape(
            self.psi_cy_c.shape[:2] + (1,) * (Q["y"].ndim - 2))
        x, y = F2.mul_many([(F2.conj(Q["x"], 32), cxx.expand(Q["x"].shape)),
                            (F2.conj(Q["y"], 32), cyy.expand(Q["y"].shape))])
        return {"x": x, "y": y, "z": F2.conj(Q["z"], 32)}

    # ------------------------------------------------------------------
    # fused doubling + tangent-line step (RCB15 Alg 9 for a = 0, sharing
    # multiplication rounds with the line coefficients; matches Curve.dbl
    # on the group output)
    # ------------------------------------------------------------------
    def _dbl_line(self, T, xp_e, yp_e):
        F2 = self.f2
        X, Y, Z = T["x"], T["y"], T["z"]
        t0, t1, zz, xy, xx = F2.mul_many([
            (Y, Y), (Y, Z), (Z, Z), (X, Y), (X, X)])
        N = F2.mul_small(xx, 3)                  # 3 X^2
        D = F2.mul_small(t1, 2)                  # 2 Y Z
        e8 = F2.mul_small(t0, 8)
        t2, DZ, NZ, NX, DY = F2.mul_many([
            (zz, self._b3()), (D, Z), (N, Z), (N, X), (D, Y)])
        Y3t = F2.add(t0, t2)
        t2_9 = F2.mul_small(t2, 3)
        t0s = F2.sub(t0, t2_9, k=32)
        X3, Z3, Ya, Xa = F2.mul_many([
            (t2, e8), (t1, e8), (t0s, Y3t), (t0s, xy)])
        T2 = {"x": F2.mul_small(Xa, 2), "y": F2.add(Ya, X3), "z": Z3}
        # line: c_y = (D Z) yp, c_x = -(N Z) xp, c_1 = N X - D Y
        cy, cx = self._mul_base_pair(DZ, yp_e, NZ, xp_e)
        terms = self._assemble(cy, F2.neg(cx, k=16), F2.sub(NX, DY, k=16))
        return T2, terms

    def _add_line(self, T, Qx, Qy, xp_e, yp_e):
        """Fused chord line + complete add T + Q (Q affine twist point,
        z = 1; RCB15 Alg 7 specialised)."""
        F2 = self.f2
        X1, Y1, Z1 = T["x"], T["y"], T["z"]
        t0, t1, QxZ, QyZ, QxY, QyX = F2.mul_many([
            (X1, Qx), (Y1, Qy), (Qx, Z1), (Qy, Z1), (Qx, Y1), (Qy, X1)])
        t3 = F2.add(QxY, QyX)                    # X1 Y2 + X2 Y1
        t4 = F2.add(Y1, QyZ)                     # Y1 Z2 + Y2 Z1  (Z2 = 1)
        t5 = F2.add(X1, QxZ)                     # X1 Z2 + X2 Z1
        N = F2.sub(Y1, QyZ, k=16)                # line numerator
        Dd = F2.sub(X1, QxZ, k=16)
        Ft, G, NQx, DQy = F2.mul_many([
            (Z1, self._b3()), (t5, self._b3()), (N, Qx), (Dd, Qy)])
        Zt = F2.add(t1, Ft)                      # Y1Y2 + 3b Z1Z2
        M = F2.sub(t1, Ft, k=16)
        t0_3 = F2.mul_small(t0, 3)
        X3a, X3b, Y3a, Y3b, Z3a, Z3b = F2.mul_many([
            (t3, M), (t4, G), (M, Zt), (t0_3, G), (t4, Zt), (t3, t0_3)])
        T3 = {"x": F2.sub(X3a, X3b, k=16),
              "y": F2.add(Y3a, Y3b),
              "z": F2.add(Z3a, Z3b)}
        cy, cx = self._mul_base_pair(Dd, yp_e, N, xp_e)
        terms = self._assemble(cy, F2.neg(cx, k=16),
                               F2.sub(NQx, DQy, k=32))
        return T3, terms

    def _b3(self):
        """Twist constant 3*b2 as an Fp2 tensor (broadcast by mul_many)."""
        return self.g2._b3

    def _mul_base_pair(self, a2, c_a, b2, c_b):
        """Two Fp2-by-base products as one stacked base mul round."""
        st = torch.stack([a2, b2], dim=2)              # (2, L, 2, *batch)
        ce = torch.stack([c_a, c_b], dim=1)            # (L, 2, *batch)
        out = self.f2.mul_base(st, ce)
        return out[:, :, 0], out[:, :, 1]

    def _assemble(self, c_y, c_x, c_1):
        """Place the three Fp2 coefficients at twist-dependent s-positions.
        D-twist: l = c_y + c_x s + c_1 s^3;  M-twist: multiply the affine
        line by xi: l = xi c_y + c_1 s^3 + c_x s^5."""
        if self.cp.twist == "D":
            return [(0, c_y), (1, c_x), (3, c_1)]
        return [(0, self.t12._xi_mul(c_y)), (3, c_1), (5, c_x)]

    # ------------------------------------------------------------------
    def miller(self, Q, P_affine):
        """Miller loop; Q = projective twist point batch with z = 1 (the add
        steps treat Q as affine); P_affine = (xp, yp) base-field tensors
        (L, *batch). Returns Fp12 with the same batch."""
        t12, g2 = self.t12, self.g2
        xp, yp = P_affine
        batch = Q["x"].shape[2:]
        T = dict(Q)
        f = t12.one(batch)
        for bit in self.loop_bits[1:]:
            T, terms = self._dbl_line(T, xp, yp)
            f = t12.mul_sparse(t12.sqr(f), terms)
            if bit:
                # the JAX loop computes the add step on every bit and selects
                # by bit; a host-side branch on the static bit gives the same
                # values with half the work
                T, terms = self._add_line(T, Q["x"], Q["y"], xp, yp)
                f = t12.mul_sparse(f, terms)
        if self.loop_neg:
            f = t12.conj_s(f)
            T = g2.neg(T)
        if self.cp.family == "bn":
            Q1 = self._psi(Q)
            nQ2 = g2.neg(self._psi(Q1))
            # psi outputs are projective with z = conj(1) = 1, so the
            # affine-Q add path stays valid for the two tail steps
            T, terms = self._add_line(T, Q1["x"], Q1["y"], xp, yp)
            f = t12.mul_sparse(f, terms)
            _, terms = self._add_line(T, nQ2["x"], nQ2["y"], xp, yp)
            f = t12.mul_sparse(f, terms)
        return f

    # ------------------------------------------------------------------
    def _unity_check(self, u):
        """FE(u) == 1 without computing FE: check conj(u)^E == u^E for
        E = (p^6+1)/r, as one 2-lane joint base-p-digit exponentiation
        (Frobenius powers g_i = u^(p^i), 64-entry subset-product table,
        one squaring + one gathered multiply per exponent bit)."""
        t12 = self.t12
        g = self.gamma_c
        v = torch.stack([u, t12.conj_s(u)], dim=-2)        # lane axis
        batch = v.shape[2:-1]
        gens = [v]
        for _ in range(5):
            gens.append(t12.frob(gens[-1], g))
        one = t12.one(batch)
        gl = [x.expand(one.shape) for x in gens]

        def stk(es):
            return torch.stack(es, dim=-2)

        pr = t12.mul(stk([gl[0], gl[0], gl[1], gl[3], gl[3], gl[4]]),
                     stk([gl[1], gl[2], gl[2], gl[4], gl[5], gl[5]]))
        s01, s02, s12, s34, s35, s45 = [pr[..., i, :] for i in range(6)]
        pr2 = t12.mul(stk([s01, s34]), stk([gl[2], gl[5]]))
        s012, s345 = pr2[..., 0, :], pr2[..., 1, :]
        A = [one, gl[0], gl[1], s01, gl[2], s02, s12, s012]
        B = [one, gl[3], gl[4], s34, gl[5], s35, s45, s345]
        # full 64-entry table T[hi*8+lo] = A[lo] * B[hi], one stacked round
        tab = t12.mul(stk([A[i & 7] for i in range(64)]),
                      stk([B[i >> 3] for i in range(64)]))
        acc = t12.one(batch)
        for i in self.unity_idx:
            acc = t12.mul(t12.sqr(acc), tab[..., i, :])
        return t12.eq(acc[..., 0, :], acc[..., 1, :])

    # ------------------------------------------------------------------
    def pairing_check(self, Qa, Pa, Qb, Pb):
        """e(Qa, Pa) == e(Qb, Pb)?  The two Miller loops run as ONE batch-2
        loop, all four projective inputs affinize through ONE batched Fermat
        inversion, and FE(m_a/m_b) == 1 is decided by _unity_check. Q* are
        projective twist point dicts (batch ()), P* projective G1 point dicts.
        Infinity inputs contribute the identity."""
        t12 = self.t12
        F = self.f2.base
        F2 = self.f2
        g2 = self.g2
        Q = {k: torch.stack([Qa[k], Qb[k]], dim=-1) for k in ("x", "y", "z")}
        P = {k: torch.stack([Pa[k], Pb[k]], dim=-1) for k in ("x", "y", "z")}
        infp = F.is_zero(P["z"])
        infq = F2.is_zero(Q["z"])
        # ONE Fermat chain inverts G1 z's and G2 z-norms together
        nrm = F2._norm_val(Q["z"])                        # (L, 2)
        zs = torch.cat([P["z"], nrm], dim=-1)             # (L, 4)
        inv4 = F.batch_inv(zs, axis=1)                    # zeros -> zero
        zi = inv4[..., :2]
        ni = inv4[..., 2:]
        xp, yp = F.mul_many([(P["x"], zi), (P["y"], zi)])
        z2inv = F2.mul_base(F2.conj(Q["z"], 32), ni)      # Fp2 inverse of z
        qx, qy = F2.mul_many([(Q["x"], z2inv), (Q["y"], z2inv)])
        Qaff = g2.from_affine(qx, qy)
        # substitute a harmless generator for degenerate inputs
        gen = self._gen2()
        genb = {k: v[..., None].expand(Qaff[k].shape) for k, v in gen.items()}
        Qs = g2.select(infq, genb, Qaff)
        m = self.miller(Qs, (xp, yp))
        m = t12.select(torch.logical_or(infp, infq), t12.one((2,)), m)
        ma, mb = m[..., 0, :], m[..., 1, :]
        return self._unity_check(t12.mul(ma, t12.conj_s(mb)))

    def _gen2(self):
        if self._g2gen_cache is None:
            self._g2gen_cache = {
                k: v[..., 0] for k, v in
                self.g2.encode_points([self.cp.g2]).items()}
        return self._g2gen_cache
