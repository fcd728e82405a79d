"""Per-curve, per-device context: fields, groups, MSM engines (counterpart of
kzg_tpu/context.py)."""

from __future__ import annotations

from functools import lru_cache

import torch

from .curves.params import CurveParams, get_curve
from .fields.mont import Field
from .fields.quadratic import Fp2
from .groups.ec import Curve
from .ops.msm import MSMEngine


class CurveContext:
    def __init__(self, cp: CurveParams, device):
        self.cp = cp
        self.device = torch.device(device)
        self.fp = Field(cp.fp, device)
        self.fr = Field(cp.fr, device)
        self.fp2 = Fp2(self.fp, cp.qnr)
        self.g1 = Curve(self.fp, 3 * cp.b, name=f"{cp.name}-G1")
        self.g2 = Curve(self.fp2, (3 * cp.b2[0], 3 * cp.b2[1]),
                        name=f"{cp.name}-G2")
        self.msm_g1 = MSMEngine(self.g1, self.fr, cp.r)
        self.msm_g2 = MSMEngine(self.g2, self.fr, cp.r)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; no silent
    fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kzg_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def get_context(name: str, device=None) -> CurveContext:
    """The context of curve `name` (BN254, BLS12381 or BN158; another name
    raises ValueError) on `device`."""
    cp = get_curve(name)
    return _context(cp.name, str(resolve_device(device)))


@lru_cache(maxsize=None)
def _context(name: str, device: str) -> CurveContext:
    return CurveContext(get_curve(name), device)
