"""Batched polynomial arithmetic over Fr (counterpart of kzg_tpu/ops/poly.py).

Everything here is exact mod r; the *results* (interpolant I, vanishing Z,
quotient q, evaluations) are mathematically unique, so they match the JAX
package and the reference bit for bit.

  * coefficients are limb-major Montgomery tensors (L, *batch, n) — batch
    dims let whole subproduct-tree levels run as one field multiply;
  * convolution takes the JAX package's rule, a radix-2 NTT when the
    product's padded length 2^k has k <= v2(r-1), from k = 3 on: every
    product of more than 4 coefficients on BLS12-381 (v2(r-1) = 32), none
    on BN254 (v2(r-1) = 2). Else Karatsuba down to a one-shot schoolbook
    block (one batched field mul of all coefficient pairs + a skew-reshape
    anti-diagonal sum), which does a product of at most 4 coefficients in
    one multiply. The butterflies' products are Field.mul (K1);
  * interpolation / multieval use subproduct trees over the consecutive
    integer domains the protocol uses (x = chunk index + offset); Lagrange
    denominators collapse to factorials:
        prod_{j!=i}(x_i - x_j) = (-1)^(n-1-i) i! (n-1-i)! ;
  * division is exact via reversed-series Newton inversion;
  * arbitrary sizes decompose into power-of-2 segments combined pairwise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from ..curves.params import CurveParams
from ..fields.mont import Field, ints_to_limbs

SCHOOL_BASE = 64         # Karatsuba base-case size
HORNER_BLOCK = 128       # blocked-Horner segment size
MULTIEVAL_DIRECT = 256   # <= this many points: blocked Horner, else tree
NTT_MIN_K = 3            # smallest NTT convolution, 2^3 coefficients: below
                         # it the schoolbook block takes one multiply where
                         # the NTT takes 3 k + 2


def _next_pow2(n):
    m = 1
    while m < n:
        m *= 2
    return m


class PolyEngine:
    def __init__(self, fr: Field, cp: CurveParams):
        self.F = fr
        self.cp = cp
        self.r = cp.r
        self._facts = [1]      # factorials mod r (host ints, grown on demand)
        self._iota = {}        # encoded 0..n-1 per n
        self._tw = {}          # NTT permutations and stage twiddles

    # ------------------------------------------------------------------
    # host-side helpers
    # ------------------------------------------------------------------
    def fact(self, n):
        while len(self._facts) <= n:
            self._facts.append(self._facts[-1] * len(self._facts) % self.r)
        return self._facts[n]

    def encode(self, coeffs):
        return self.F.encode(coeffs)

    def decode(self, arr):
        out = self.F.decode(arr)
        return out if isinstance(out, list) else [out]

    @staticmethod
    def _pad_last(x, n):
        pad = n - x.shape[-1]
        if pad <= 0:
            return x
        return nnf.pad(x, (0, pad))

    # ------------------------------------------------------------------
    # NTT backend
    # ------------------------------------------------------------------
    def _bitrev(self, k):
        """The bit-reversal permutation of 2^k indices, on the device."""
        key = ("perm", k)
        if key not in self._tw:
            i = torch.arange(1 << k)
            perm = torch.zeros_like(i)
            for b in range(k):
                perm |= ((i >> b) & 1) << (k - 1 - b)
            self._tw[key] = perm.to(self.F.device)
        return self._tw[key]

    def _stage_tw(self, k, s, inverse):
        """(L, 2^(s-1)) Montgomery twiddles w_m^j of stage s of a size-2^k
        NTT (w_m a primitive 2^s-th root, inverted for the inverse NTT)."""
        key = (k, s, inverse)
        if key not in self._tw:
            n, m, r = 1 << k, 1 << s, self.r
            wm = pow(self.cp.ntt_root(k), n // m, r)
            if inverse:
                wm = pow(wm, -1, r)
            tw = [1]
            for _ in range(m // 2 - 1):
                tw.append(tw[-1] * wm % r)
            mont = [t * self.F.params.mont_r % r for t in tw]
            self._tw[key] = torch.from_numpy(
                ints_to_limbs(mont, self.F.L).astype(np.int64)).to(
                    self.F.device)
        return self._tw[key]

    def ntt(self, x, inverse=False):
        """Radix-2 NTT along the last axis (length 2^k), natural order in
        and out; values re-reduced every 6 stages and at the end (the
        inverse by its product with n^-1)."""
        F = self.F
        n = x.shape[-1]
        k = n.bit_length() - 1
        assert (1 << k) == n, "NTT size must be a power of 2"
        x = x[..., self._bitrev(k)]
        for s in range(1, k + 1):
            m = 1 << s
            tw = self._stage_tw(k, s, inverse)               # (L, m/2)
            xs = x.reshape(x.shape[:-1] + (n // m, m))
            lo = xs[..., : m // 2]
            hi = xs[..., m // 2:]
            twb = tw.reshape((tw.shape[0],) + (1,) * (lo.ndim - 2)
                             + (m // 2,))
            t = F.mul(hi, twb)
            nlo = F.add(lo, t)
            nhi = F.sub(lo, t, k=4)
            x = torch.cat([nlo, nhi], dim=-1).reshape(x.shape)
            if s % 6 == 0:
                x = F.freshen(x)
        if inverse:
            n_inv = pow(n, -1, self.r)
            x = F.mul(x, F.const(n_inv, ()).reshape(
                (F.L,) + (1,) * (x.ndim - 1)))
        else:
            x = F.freshen(x)
        return x

    def _conv_ntt(self, a, b, out_n):
        F = self.F
        nfft = _next_pow2(out_n)
        fa = self.ntt(self._pad_last(a, nfft))
        fb = self.ntt(self._pad_last(b, nfft))
        return self.ntt(F.mul(fa, fb), inverse=True)[..., :out_n]

    # ------------------------------------------------------------------
    # Karatsuba / schoolbook backend
    # ------------------------------------------------------------------
    # grid lanes (batch x m x m2) per schoolbook chunk: bounds the
    # (L, lanes) partial products live at once at deg-4096 sizes
    SCHOOL_LANES = 1 << 20

    def _school_block(self, a, b):
        """(L,*B,m) x (L,*B,m2) -> (L,*B,m+m2-1): one batched field mul of
        all coefficient pairs + skew-reshape anti-diagonal sums."""
        F = self.F
        m, m2 = a.shape[-1], b.shape[-1]
        P = F.mul(a[..., :, None], b[..., None, :])        # (L,*B,m,m2)
        Pp = nnf.pad(P, (0, m))
        flat = Pp.reshape(P.shape[:-2] + (m * (m2 + m),))
        flat = flat[..., : m * (m2 + m - 1)]
        skew = flat.reshape(P.shape[:-2] + (m, m2 + m - 1))
        C = skew.sum(dim=-2)                               # limb sums
        return F._norm16(C)                                # exact 16-bit limbs

    def _conv_school(self, a, b):
        """Schoolbook conv, batch-chunked to bound live memory."""
        m, m2 = a.shape[-1], b.shape[-1]
        lead = a.shape[1:-1]
        B = 1
        for d in lead:
            B *= d
        chunk = max(1, self.SCHOOL_LANES // (m * m2))
        if B <= chunk:
            return self._school_block(a, b)
        L = a.shape[0]
        a3 = a.reshape(L, B, m)
        b3 = b.reshape(L, B, m2)
        outs = [self._school_block(a3[:, i:i + chunk], b3[:, i:i + chunk])
                for i in range(0, B, chunk)]
        return torch.cat(outs, dim=1).reshape((L,) + lead + (m + m2 - 1,))

    def _conv_kara(self, a, b):
        """Equal power-of-2 size Karatsuba convolution (length 2m-1).

        Level-batched: at each level the three half-size subproblems of every
        pair are stacked into the batch axis (B -> 3B, m -> m/2), so the
        whole recursion is depth-many full-width multiplies."""
        F = self.F
        m = a.shape[-1]
        lead = a.shape[:-1]
        a = a.reshape(a.shape[:1] + (-1, m))               # (L, B, m)
        b = b.reshape(b.shape[:1] + (-1, m))
        B0 = a.shape[1]
        while m > SCHOOL_BASE:
            h = m // 2
            a0, a1 = a[..., :h], a[..., h:]
            b0, b1 = b[..., :h], b[..., h:]
            one = F.ones((1, 1))                           # freshen both
            asum, bsum = F.mul_many([(a0 + a1, one), (b0 + b1, one)])
            a = torch.cat([a0, a1, asum], dim=-2)          # (L, 3B, h)
            b = torch.cat([b0, b1, bsum], dim=-2)
            m = h
        z = self._conv_school(a, b)                        # (L, 3^d B, 2m-1)
        total_m = m
        while z.shape[-2] > B0:
            B = z.shape[-2] // 3
            z0 = z[..., 0 * B:1 * B, :]
            z2 = z[..., 1 * B:2 * B, :]
            zm = z[..., 2 * B:3 * B, :]
            h = total_m
            # k covers value(z0 + z2): base-level schoolbook outputs reach
            # ~2 * SCHOOL_BASE * 1.2 p before their freshen
            t = F.sub(zm, z0 + z2, k=256)
            out = self._pad_last(z0, 4 * h - 1).clone()
            out[..., h:h + 2 * h - 1] += t
            out[..., 2 * h:2 * h + 2 * h - 1] += z2
            z = F.freshen(out)
            total_m *= 2
        return z.reshape(lead + (2 * total_m - 1,))

    def conv(self, a, b):
        """Full polynomial product along the last axis (exact mod r).
        Output values are fresh (<= 1.1p)."""
        na, nb = a.shape[-1], b.shape[-1]
        if na == 0 or nb == 0:
            return torch.zeros(a.shape[:-1] + (max(na + nb - 1, 1),),
                               dtype=a.dtype, device=a.device)
        out_n = na + nb - 1
        k = _next_pow2(out_n).bit_length() - 1
        if NTT_MIN_K <= k <= self.cp.fr_two_adicity:
            return self._conv_ntt(a, b, out_n)
        m = _next_pow2(max(na, nb))
        a, b = self._bc(self._pad_last(a, m), self._pad_last(b, m))
        c = self._conv_kara(a, b)
        return self.F.freshen(c[..., :out_n])

    @staticmethod
    def _bc(a, b):
        """Broadcast the batch dims (all but limb and coefficient axes)."""
        if a.shape[1:-1] == b.shape[1:-1]:
            return a, b
        shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        return (a.expand(shape + a.shape[-1:]),
                b.expand(shape + b.shape[-1:]))

    # ------------------------------------------------------------------
    # series inversion and division
    # ------------------------------------------------------------------
    def inv_series(self, f, m):
        """g with f*g = 1 mod x^m (f[..., 0] must be invertible)."""
        F = self.F
        g = F.inv(f[..., 0:1])
        prec = 1
        while prec < m:
            prec = min(2 * prec, m)
            fg = self.conv(f[..., :min(prec, f.shape[-1])], g)[..., :prec]
            t = F.neg(fg, 4)                               # -f g
            two = F.mul_small(F.ones(t.shape[1:-1] + (1,)), 2)
            t = torch.cat([t[..., 0:1] + two, t[..., 1:]], dim=-1)  # 2 - f g
            g = self.conv(g, t)[..., :prec]
        return g

    def _geom_series(self, r0, m):
        """[1, r, r^2, ..., r^(m-1)] along the last axis (r0: (L, *B, 1)
        Montgomery); log2(m) full-width muls via block doubling."""
        F = self.F
        P = F.ones(r0.shape[1:-1] + (1,))
        while P.shape[-1] < m:
            step = F.mul(P[..., -1:], r0)                  # r^len
            P = torch.cat([P, F.mul(P, step)], dim=-1)
        return P[..., :m]

    def divmod(self, a, b):
        """(q, rem) with a = q*b + rem, deg rem < deg b (static lengths;
        leading coeff of b must be invertible — ours are monic)."""
        F = self.F
        na, nb = a.shape[-1], b.shape[-1]
        if na < nb:
            return (torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype,
                                device=a.device),
                    self._pad_last(a, max(1, nb - 1)))
        nq = na - nb + 1
        if nb == 2:
            # monic degree-1 divisor (x - r): rev(b) = [1, -r], whose series
            # inverse is the geometric series in r (the single-point proof's
            # quotient). r = -c0; c0 may carry lazy value (~100p from the
            # vanishing leaves' lifted neg), so re-reduce then negate exactly
            root = F.neg(F.freshen(b[..., 0:1]), 2, lazy=False)
            binv = self._geom_series(root, nq)
        else:
            binv = self.inv_series(b.flip(-1), nq)
        qr = self.conv(a.flip(-1)[..., :nq], binv)[..., :nq]
        q = qr.flip(-1)
        if nb == 1:
            return q, torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype,
                                  device=a.device)
        qb = self.conv(q, b)[..., : nb - 1]
        rem = F.sub(a[..., : nb - 1], qb, k=4)
        return q, rem

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def eval_points(self, coeffs, xs):
        """Evaluate one poly (L, n) at points (L, k): blocked Horner,
        sequential depth ~ HORNER_BLOCK + n/HORNER_BLOCK."""
        F = self.F
        n = coeffs.shape[-1]
        m = min(HORNER_BLOCK, n)
        nb = -(-n // m)
        c = self._pad_last(coeffs, nb * m)
        c = c.reshape(c.shape[:-1] + (nb, m))              # (L, nb, m)
        kpts = xs.shape[-1]
        xb = xs[..., :, None]                              # (L, k, 1)
        acc = torch.zeros(coeffs.shape[:-1] + (kpts, nb), dtype=torch.int64,
                          device=coeffs.device)
        for j in range(m - 1, -1, -1):
            acc = F.mul(acc, xb) + c[..., None, :, j]      # (L, k, nb)
        xm = self._pow_int(xs, m)                          # (L, k)
        a2 = torch.zeros_like(xs)
        for j in range(nb - 1, -1, -1):
            a2 = F.mul(a2, xm) + acc[..., j]
        return F.freshen(a2)

    def _pow_int(self, x, e):
        F = self.F
        acc = None
        base = x
        while e:
            if e & 1:
                acc = base if acc is None else F.mul(acc, base)
            e >>= 1
            if e:
                base = F.sqr(base)
        return acc if acc is not None else F.ones(x.shape[1:])

    # ------------------------------------------------------------------
    # consecutive-integer domain machinery
    # ------------------------------------------------------------------
    def domain_mont(self, offset_m, n):
        """x-coords offset..offset+n-1; offset_m is a Montgomery scalar (L,)."""
        if n not in self._iota:
            self._iota[n] = self.F.encode(list(range(n)))  # (L, n)
        return offset_m[..., None] + self._iota[n]

    @staticmethod
    def _seg_sizes(n):
        out = []
        bit = 1 << (n.bit_length() - 1)
        while bit:
            if n & bit:
                out.append(bit)
            bit >>= 1
        return out

    def _build_seg_tree(self, offset_m, size):
        """Subproduct tree for [offset, offset+size), size = 2^k: list of
        levels, level j = (L, size/2^j, 2^j + 1) monic vanishing polys."""
        F = self.F
        xs = self.domain_mont(offset_m, size)              # (L, size)
        leaves = torch.stack([F.neg(xs, 8), F.ones((size,))], dim=-1)
        levels = [leaves]
        cur = leaves
        while cur.shape[-2] > 1:
            cur = self.conv(cur[..., 0::2, :], cur[..., 1::2, :])
            levels.append(cur)
        return levels

    def _shift_off(self, offset_m, delta):
        if delta == 0:
            return offset_m
        return offset_m + self.F.encode([delta])[..., 0]

    def vanishing(self, offset_m, n):
        """Z(x) = prod_{i<n} (x - offset - i): (L, n+1), monic."""
        acc = None
        pos = 0
        for s in self._seg_sizes(n):
            root = self._build_seg_tree(
                self._shift_off(offset_m, pos), s)[-1][..., 0, :]
            acc = root if acc is None else self.conv(acc, root)
            pos += s
        return acc

    def interpolate(self, offset_m, ys):
        """Unique I (length n) with I(offset + i) = ys[i]; ys (L, n);
        offset_m = Montgomery scalar (L,)."""
        F = self.F
        n = ys.shape[-1]
        r = self.r
        dens = []
        for i in range(n):
            d = self.fact(i) * self.fact(n - 1 - i) % r
            if (n - 1 - i) % 2 == 1:
                d = (r - d) % r
            dens.append(pow(d, -1, r))
        cs = F.mul(ys, F.encode(dens))
        acc_S = acc_Z = None
        pos = 0
        for s in self._seg_sizes(n):
            S, Z = self._interp_seg(self._shift_off(offset_m, pos),
                                    cs[..., pos:pos + s], s)
            if acc_S is None:
                acc_S, acc_Z = S, Z
            else:
                sa = self.conv(acc_S, Z)
                sb = self.conv(S, acc_Z)
                nn = max(sa.shape[-1], sb.shape[-1])
                acc_S = self._pad_last(sa, nn) + self._pad_last(sb, nn)
                acc_Z = self.conv(acc_Z, Z)
            pos += s
        return self._pad_last(acc_S, n)[..., :n]

    def _interp_seg(self, offset_m, cs, size):
        """D&C  sum_i c_i prod_{j!=i}(x - x_j)  within one pow2 segment.
        Returns (S (L, size), Z (L, size+1))."""
        levels = self._build_seg_tree(offset_m, size)
        S = cs[..., :, None]                               # (L, size, 1)
        for lv in levels[:-1]:
            Se, So = S[..., 0::2, :], S[..., 1::2, :]
            Ze, Zo = lv[..., 0::2, :], lv[..., 1::2, :]
            # both products of the level as one stacked convolution
            prod = self.conv(torch.stack([Se, So], dim=1),
                             torch.stack([Zo, Ze], dim=1))
            S = prod[:, 0] + prod[:, 1]
        return S[..., 0, :], levels[-1][..., 0, :]

    def multieval(self, coeffs, offset_m, k):
        """P(offset..offset+k-1) as (L, k) Montgomery values (coeffs (L, n)):
        blocked Horner up to MULTIEVAL_DIRECT points, subproduct-tree
        remainders per power-of-2 segment above it (identical values)."""
        if k <= MULTIEVAL_DIRECT:
            return self.eval_points(coeffs, self.domain_mont(offset_m, k))
        outs = []
        pos = 0
        for s in self._seg_sizes(k):
            off = self._shift_off(offset_m, pos)
            if s <= MULTIEVAL_DIRECT:
                outs.append(self.eval_points(coeffs, self.domain_mont(off, s)))
            else:
                outs.append(self._multieval_seg(coeffs, off, s))
            pos += s
        return torch.cat(outs, dim=-1)

    def _multieval_seg(self, coeffs, offset_m, size):
        levels = self._build_seg_tree(offset_m, size)
        root = levels[-1][..., 0, :]                       # (L, size+1)
        if coeffs.shape[-1] >= root.shape[-1]:
            rem = self.divmod(coeffs, root)[1]             # (L, size)
        else:
            rem = self._pad_last(coeffs, size)
        cur = rem[..., None, :]                            # (L, 1, size)
        for lv in reversed(levels[:-1]):
            B = lv.shape[-2]
            dup = torch.stack([cur, cur], dim=-2)          # (L, B/2, 2, m')
            dup = dup.reshape(cur.shape[:-2] + (B, cur.shape[-1]))
            cur = self.divmod(dup, lv)[1]                  # (L, B, m)
        return cur[..., 0]                                 # (L, size)

    def quotient(self, P, I, Z):
        """(P - I) / Z, exact division."""
        F = self.F
        n = P.shape[-1]
        diff = F.sub(P, self._pad_last(I, n), k=4)
        q, _ = self.divmod(diff, Z)
        return q
