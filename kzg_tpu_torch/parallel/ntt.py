"""Distributed NTT over a mesh of ranks (four-step / Bailey decomposition;
counterpart of kzg_tpu/parallel/ntt.py).

With n = D * n2 and the coefficient axis contiguously block-sharded over D
ranks,

    X[k2 + n2*k1] = sum_{j1} w^(n2*j1*k1) * w^(j1*k2)
                    * sum_{j2} x[j1 + D*j2] * (w^D)^(j2*k2)

  1. one all_to_all re-stripes the blocks so rank j1 holds the strided
     residue class {j : j = j1 mod D};
  2. each rank runs a LOCAL length-n2 NTT (ops.poly.PolyEngine.ntt, whose
     canonical size-n2 root is w^D since ntt_root(k)^2 = ntt_root(k-1));
  3. a pointwise twiddle by w^(j1*k2) (Field.mul: K1 on the card);
  4. an all_gather and the length-D combine (K1 products and adds) leave X
     contiguously sharded on k, ready for the pointwise product of a
     sharded convolution.

Every tensor argument and result is this rank's block (L, n / D).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.mont import ints_to_limbs
from ..ops.poly import PolyEngine
from .distributed import Mesh, all_gather, all_to_all


class DistributedNTT:
    """Callable NTT/INTT over `mesh` for power-of-2 sizes n with
    (mesh size)^2 | n."""

    def __init__(self, pe: PolyEngine, mesh: Mesh):
        self.pe = pe
        self.F = pe.F
        self.mesh = mesh
        self.D = mesh.size
        self._tables = {}

    def _consts(self, n: int, inverse: bool):
        """(this rank's twiddle row (L, n2), its combine row (L, D))
        Montgomery tables; the inverse's combine scales by D^-1 (the local
        INTT scales by n2^-1)."""
        key = (n, inverse)
        if key not in self._tables:
            D, r, F = self.D, self.pe.r, self.F
            me = self.mesh.rank
            n2 = n // D
            k = n.bit_length() - 1
            w = self.pe.cp.ntt_root(k)
            if inverse:
                w = pow(w, -1, r)
            mont = F.params.mont_r
            tw = [pow(w, me * k2, r) * mont % r for k2 in range(n2)]
            scale = pow(D, -1, r) if inverse else 1
            W = [pow(w, n2 * j1 * me, r) * scale * mont % r
                 for j1 in range(D)]

            def dev(vals):
                return torch.from_numpy(ints_to_limbs(vals, F.L).astype(
                    np.int64)).to(F.device)
            self._tables[key] = (dev(tw), dev(W))
        return self._tables[key]

    def __call__(self, x, inverse: bool = False):
        F, D = self.F, self.D
        L, n2 = x.shape
        n = D * n2
        if n2 % D or n & (n - 1):
            raise ValueError(f"n = {n}: the four-step NTT needs a power of 2 "
                             "divisible by the square of the mesh size")
        tw, W = self._consts(n, inverse)
        # 1. re-stripe: contiguous block -> residue class j = me (mod D)
        t = x.reshape(L, n2 // D, D).permute(2, 0, 1)      # to rank j1
        t = all_to_all(t, self.mesh)                       # (D, L, n2 / D)
        row = t.permute(1, 0, 2).reshape(L, n2)            # x[me + D*j2]
        # 2. local butterflies, root w^D == canonical size-n2 root
        T = self.pe.ntt(row, inverse=inverse)
        # 3. twiddle w^(me*k2)
        T = F.mul(T, tw)
        # 4. outer length-D NTT: gather rows, combine with my W row
        allT = all_gather(T, self.mesh)                    # (D, L, n2)
        acc = None
        for j1 in range(D):
            term = F.mul(allT[j1], W[:, j1:j1 + 1])
            acc = term if acc is None else F.add(acc, term)
        return F.freshen(acc)                              # X[me*n2 + k2]

    def conv(self, a, b, out_n: int):
        """Sharded convolution of two polynomials whose blocks of the
        zero-padded length n (out_n <= n) this rank holds: NTT both,
        pointwise product (stays sharded), inverse NTT; returns this rank's
        block of the product truncated to out_n (empty past it)."""
        prod = self.F.mul(self(a), self(b))
        out = self(prod, inverse=True)
        n2 = out.shape[-1]
        keep = min(max(out_n - self.mesh.rank * n2, 0), n2)
        return out[..., :keep]
