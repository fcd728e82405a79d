"""Exact pure-Python pieces the port needs at run time.

A copy of the parts of kzg_tpu/refmodel/model.py that the protocol runs:
  * ``Tower`` and ``frobenius_gammas`` — the Fp12 Frobenius constants and the
    G2 on-curve check of protocol.serial;
  * ``G1`` / ``G2`` affine groups — the generator doubling tables of setup
    generation and its 3-point self-check;
  * the part of ``Pairing`` that pairing.engine derives the twist Frobenius
    psi from (untwist and Frobenius on E(Fp12)).
Plain python ints, no dependencies.
"""

from __future__ import annotations

from ..curves.params import CurveParams


def finv(a: int, m: int) -> int:
    return pow(a, -1, m)


# ============================================================================
# Fp2 / Fp6 / Fp12 tower
#   Fp2  = Fp[w]/(w^2 - qnr)          elements (a, b)
#   Fp6  = Fp2[v]/(v^3 - xi)          elements (c0, c1, c2)
#   Fp12 = Fp6[s]/(s^2 - v)           elements (d0, d1)
# ============================================================================

class Tower:
    def __init__(self, cp: CurveParams):
        self.p = cp.p
        self.qnr = cp.qnr % cp.p
        self.xi = (cp.xi[0] % cp.p, cp.xi[1] % cp.p)

    # ---- Fp2 ----
    def e2_add(self, x, y):
        p = self.p
        return ((x[0] + y[0]) % p, (x[1] + y[1]) % p)

    def e2_sub(self, x, y):
        p = self.p
        return ((x[0] - y[0]) % p, (x[1] - y[1]) % p)

    def e2_neg(self, x):
        p = self.p
        return ((-x[0]) % p, (-x[1]) % p)

    def e2_mul(self, x, y):
        p, q = self.p, self.qnr
        return ((x[0] * y[0] + q * x[1] * y[1]) % p,
                (x[0] * y[1] + x[1] * y[0]) % p)

    def e2_smul(self, x, c: int):
        p = self.p
        return (x[0] * c % p, x[1] * c % p)

    def e2_sqr(self, x):
        return self.e2_mul(x, x)

    def e2_inv(self, x):
        p, q = self.p, self.qnr
        d = (x[0] * x[0] - q * x[1] * x[1]) % p
        di = finv(d, p)
        return (x[0] * di % p, (-x[1] * di) % p)

    def e2_conj(self, x):
        return (x[0], (-x[1]) % self.p)

    def e2_pow(self, x, e: int):
        r = (1, 0)
        while e:
            if e & 1:
                r = self.e2_mul(r, x)
            x = self.e2_sqr(x)
            e >>= 1
        return r

    def e2_mul_xi(self, x):
        return self.e2_mul(x, self.xi)

    # ---- Fp6 (tuples of 3 Fp2) ----
    def e6_zero(self):
        return ((0, 0), (0, 0), (0, 0))

    def e6_add(self, x, y):
        return tuple(self.e2_add(a, b) for a, b in zip(x, y))

    def e6_sub(self, x, y):
        return tuple(self.e2_sub(a, b) for a, b in zip(x, y))

    def e6_neg(self, x):
        return tuple(self.e2_neg(a) for a in x)

    def e6_mul(self, x, y):
        m, ad, xi = self.e2_mul, self.e2_add, self.e2_mul_xi
        a0, a1, a2 = x
        b0, b1, b2 = y
        t0, t1, t2 = m(a0, b0), m(a1, b1), m(a2, b2)
        c0 = ad(t0, xi(self.e2_sub(self.e2_sub(
            m(ad(a1, a2), ad(b1, b2)), t1), t2)))
        c1 = ad(self.e2_sub(self.e2_sub(m(ad(a0, a1), ad(b0, b1)), t0), t1),
                xi(t2))
        c2 = ad(self.e2_sub(self.e2_sub(m(ad(a0, a2), ad(b0, b2)), t0), t2), t1)
        return (c0, c1, c2)

    def e6_mul_v(self, x):
        """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return (self.e2_mul_xi(x[2]), x[0], x[1])

    def e6_inv(self, x):
        m, s, xi = self.e2_mul, self.e2_sqr, self.e2_mul_xi
        a0, a1, a2 = x
        c0 = self.e2_sub(s(a0), xi(m(a1, a2)))
        c1 = self.e2_sub(xi(s(a2)), m(a0, a1))
        c2 = self.e2_sub(s(a1), m(a0, a2))
        t = self.e2_add(xi(self.e2_add(m(a2, c1), m(a1, c2))), m(a0, c0))
        ti = self.e2_inv(t)
        return (m(c0, ti), m(c1, ti), m(c2, ti))

    # ---- Fp12 (tuples of 2 Fp6) ----
    def e12_mul(self, x, y):
        a0, a1 = x
        b0, b1 = y
        t0 = self.e6_mul(a0, b0)
        t1 = self.e6_mul(a1, b1)
        c0 = self.e6_add(t0, self.e6_mul_v(t1))
        c1 = self.e6_sub(self.e6_sub(
            self.e6_mul(self.e6_add(a0, a1), self.e6_add(b0, b1)), t0), t1)
        return (c0, c1)

    def e12_inv(self, x):
        a0, a1 = x
        t = self.e6_sub(self.e6_mul(a0, a0),
                        self.e6_mul_v(self.e6_mul(a1, a1)))
        ti = self.e6_inv(t)
        return (self.e6_mul(a0, ti), self.e6_neg(self.e6_mul(a1, ti)))

    def e12_frob(self, x, gammas):
        """Frobenius x -> x^p: conjugate each flat coefficient, multiply
        coefficient k by gammas[k-1]."""
        co = self.e12_coeffs(x)
        out = []
        for k, c in enumerate(co):
            c = self.e2_conj(c)
            if k > 0:
                c = self.e2_mul(c, gammas[k - 1])
            out.append(c)
        return self.e12_from_coeffs(out)

    def e12_coeffs(self, x):
        """Flat coefficients of s^k, k=0..5 (s^2 = v): a + b*s with
        a=(a0,a1,a2), b=(b0,b1,b2) -> (a0, b0, a1, b1, a2, b2)."""
        a, b = x
        return (a[0], b[0], a[1], b[1], a[2], b[2])

    def e12_from_coeffs(self, co):
        return ((co[0], co[2], co[4]), (co[1], co[3], co[5]))


def frobenius_gammas(tw: Tower):
    """gamma1[k-1] = xi^(k*(p-1)/6) in Fp2 for k=1..5 (p = 1 mod 6 for both
    BN and BLS12 families)."""
    p = tw.p
    assert (p - 1) % 6 == 0
    g1 = tw.e2_pow(tw.xi, (p - 1) // 6)
    gs = [g1]
    for _ in range(4):
        gs.append(tw.e2_mul(gs[-1], g1))
    return gs


# ============================================================================
# Elliptic curve groups (affine, None = point at infinity)
# ============================================================================

class G1:
    def __init__(self, cp: CurveParams):
        self.p, self.b = cp.p, cp.b
        self.gen = cp.g1

    def is_on(self, P):
        if P is None:
            return True
        x, y = P
        return (y * y - x * x * x - self.b) % self.p == 0

    def neg(self, P):
        return None if P is None else (P[0], (-P[1]) % self.p)

    def add(self, P, Q):
        p = self.p
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = 3 * x1 * x1 * finv(2 * y1, p) % p
        else:
            lam = (y2 - y1) * finv((x2 - x1) % p, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    def mul(self, k: int, P):
        R = None
        k = int(k)
        while k:
            if k & 1:
                R = self.add(R, P)
            P = self.add(P, P)
            k >>= 1
        return R


class G2:
    def __init__(self, cp: CurveParams):
        self.tw = Tower(cp)
        self.b2 = (cp.b2[0] % cp.p, cp.b2[1] % cp.p)
        self.gen = cp.g2

    def is_on(self, P):
        if P is None:
            return True
        t = self.tw
        x, y = P
        return t.e2_sub(t.e2_sqr(y),
                        t.e2_add(t.e2_mul(t.e2_sqr(x), x), self.b2)) == (0, 0)

    def neg(self, P):
        return None if P is None else (P[0], self.tw.e2_neg(P[1]))

    def add(self, P, Q):
        t = self.tw
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if t.e2_add(y1, y2) == (0, 0):
                return None
            lam = t.e2_mul(t.e2_smul(t.e2_sqr(x1), 3),
                           t.e2_inv(t.e2_smul(y1, 2)))
        else:
            lam = t.e2_mul(t.e2_sub(y2, y1), t.e2_inv(t.e2_sub(x2, x1)))
        x3 = t.e2_sub(t.e2_sub(t.e2_sqr(lam), x1), x2)
        return (x3, t.e2_sub(t.e2_mul(lam, t.e2_sub(x1, x3)), y1))

    def mul(self, k: int, P):
        R = None
        k = int(k)
        while k:
            if k & 1:
                R = self.add(R, P)
            P = self.add(P, P)
            k >>= 1
        return R


# ============================================================================
# Untwist and Frobenius on E(Fp12) — what pairing.engine derives psi from
# ============================================================================

class Pairing:
    def __init__(self, cp: CurveParams):
        self.cp = cp
        self.tw = Tower(cp)
        t = self.tw
        # s^2 = v, s^6 = xi. Untwist maps E'(Fp2) -> E(Fp12):
        #   D-twist (y^2 = x^3 + b/xi):  (x, y) -> (x*s^2, y*s^3)
        #   M-twist (y^2 = x^3 + b*xi):  (x, y) -> (x/s^2, y/s^3)
        s2 = ((0, 0), (1, 0), (0, 0))          # v  = s^2  in Fp6 (coeff of v)
        self.s2 = (s2, t.e6_zero())            # Fp12 element s^2
        s3_hi = ((0, 0), (1, 0), (0, 0))       # s^3 = v*s -> Fp6 coeff v on s
        self.s3 = (t.e6_zero(), s3_hi)
        if cp.twist == "M":
            self.s2 = t.e12_inv(self.s2)
            self.s3 = t.e12_inv(self.s3)
        self.gammas = frobenius_gammas(t)

    def untwist(self, Q):
        t = self.tw
        x, y = Q
        X = t.e12_mul(((x, (0, 0), (0, 0)), t.e6_zero()), self.s2)
        Y = t.e12_mul(((y, (0, 0), (0, 0)), t.e6_zero()), self.s3)
        return (X, Y)

    def frob_g2(self, Q, k=1):
        """pi^k on the untwisted point: raise coordinates to p^k via
        Frobenius of Fp12 (k applications)."""
        t = self.tw
        x, y = Q
        for _ in range(k):
            x = t.e12_frob(x, self.gammas)
            y = t.e12_frob(y, self.gammas)
        return (x, y)
