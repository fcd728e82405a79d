"""Carry a trusted setup across from the JAX package.

The setup plays the part that weights play in a model port: the one large
state both packages must share. ``setup_from_arrays`` takes the canonical
affine arrays that ``kzg_tpu``'s ``Curve.affine_packed`` returns — numpy,
``(C*2*L + 1, n)`` uint32 with x limbs, y limbs and an infinity flag
(C = 1 for G1, 2 for G2) — and returns the port's ``trusted_setup`` with the
points on the device of the initialized protocol.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves.params import LIMB_MASK
from .protocol.api import _ctx, trusted_setup


def _check_packed(arr, comps, L, name):
    a = np.asarray(arr)
    if a.ndim != 2 or a.shape[0] != comps * 2 * L + 1:
        raise ValueError(f"{name}: expected shape ({comps * 2 * L + 1}, n), "
                         f"got {a.shape}")
    if not np.issubdtype(a.dtype, np.integer):
        raise ValueError(f"{name}: integer limbs expected, got {a.dtype}")
    if a.size and (a.min() < 0 or a[:-1].max() > LIMB_MASK):
        raise ValueError(f"{name}: limbs must be canonical 16-bit values")
    if np.any((a[-1] != 0) & (a[-1] != 1)):
        raise ValueError(f"{name}: infinity flag must be 0 or 1")
    return a.astype(np.int64)


def _to_device(grp, a, L):
    """Packed canonical affine (numpy) -> projective Montgomery points."""
    base = grp.F.base if grp.is_fp2 else grp.F
    t = torch.from_numpy(a).to(base.device)
    n = t.shape[-1]
    if grp.is_fp2:
        def coord(rows):      # (2L, n) -> (2, L, n) Montgomery, one mul
            return torch.movedim(base.to_mont(
                torch.movedim(rows.reshape(2, L, n), 0, 1)), 1, 0)
        x, y = coord(t[:2 * L]), coord(t[2 * L:4 * L])
    else:
        x, y = base.to_mont(t[:L]), base.to_mont(t[L:2 * L])
    return grp.from_affine(x, y, t[-1] != 0)


def setup_from_arrays(g1_packed, g2_packed, device=None) -> trusted_setup:
    """JAX-package affine_packed setup arrays -> the port's trusted_setup.

    Requires ``kzg_tpu_torch.init()`` first; `device`, when given, must be
    the initialized device. Coordinates not below p or points off the curve
    raise ValueError."""
    pc = _ctx()
    if device is not None and torch.device(device).type != pc.device.type:
        raise ValueError(f"setup_from_arrays: protocol initialized on "
                         f"{pc.device}, not {device}")
    L = pc.ctx.fp.L
    a1 = _check_packed(g1_packed, 1, L, "g1_packed")
    a2 = _check_packed(g2_packed, 2, L, "g2_packed")
    if a1.shape[1] != a2.shape[1] or a1.shape[1] < 2:
        raise ValueError("setup_from_arrays: G1 and G2 need the same count "
                         ">= 2 of points")
    p = pc.cp.p
    host = []
    for grp, a, og in ((pc.ctx.g1, a1, pc.og1), (pc.ctx.g2, a2, pc.og2)):
        pts = grp.unpack_affine(a)
        for P in pts:
            coords = () if P is None else (
                P[0] + P[1] if grp.is_fp2 else P)
            if any(c >= p for c in coords) or not og.is_on(P):
                raise ValueError(f"setup_from_arrays: {grp.name} point not "
                                 "on the curve")
        host.append(pts)
    ts = trusted_setup._from_device_points(_to_device(pc.ctx.g1, a1, L),
                                           _to_device(pc.ctx.g2, a2, L))
    ts._g1_host, ts._g2_host = host
    return ts
