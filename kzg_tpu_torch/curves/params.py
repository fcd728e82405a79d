"""Runtime curve-parameter registry (counterpart of kzg_tpu/curves/params.py).

``get_curve("BN254")`` returns a frozen :class:`CurveParams` carrying every
derived constant the port needs: limb layouts, Montgomery constants, tower
non-residues, generators. The values are those of ``kzg_tpu.curves.params``;
the tests hold the two registries equal.

Limb convention: field elements are little-endian base-2^16 limbs, limb-major
``(L, *batch)``. The port stores them in int64 tensors (torch's uint32 lacks
shifts on the CPU); values and the Montgomery radix R = 2^(16 L) are the same
as the JAX package's, so the same numpy limb arrays feed both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

from .params_data import CURVES

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def num_limbs(modulus: int) -> int:
    """Limbs per element. One more than strictly needed so that the Montgomery
    radix R = 2^(16 L) satisfies R >= 2^16 * modulus — the headroom that makes
    the lazy (redundant-limb) arithmetic of fields.mont carry-safe without
    per-op canonicalization."""
    return (modulus.bit_length() + 31) // LIMB_BITS


def to_limbs(value: int, n: int) -> tuple:
    return tuple((value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n))


def from_limbs(limbs) -> int:
    v = 0
    for i, l in enumerate(limbs):
        v |= int(l) << (LIMB_BITS * i)
    return v


@dataclass(frozen=True)
class FieldParams:
    """Montgomery arithmetic constants for one prime field."""
    modulus: int
    n_limbs: int
    mont_r: int          # R = 2^(16*n_limbs) mod modulus
    mont_r2: int         # R^2 mod modulus
    mont_r3: int         # R^3 mod modulus
    pprime: int          # -modulus^-1 mod 2^(16*n_limbs)  (full width)
    limbs: tuple         # modulus as limbs
    r2_limbs: tuple
    one_limbs: tuple     # R mod modulus as limbs (Montgomery form of 1)

    @staticmethod
    def make(modulus: int) -> "FieldParams":
        n = num_limbs(modulus)
        Rfull = 1 << (LIMB_BITS * n)
        R = Rfull % modulus
        r2 = R * R % modulus
        r3 = r2 * R % modulus
        pprime = (-pow(modulus, -1, Rfull)) % Rfull
        return FieldParams(
            modulus=modulus, n_limbs=n, mont_r=R, mont_r2=r2, mont_r3=r3,
            pprime=pprime, limbs=to_limbs(modulus, n),
            r2_limbs=to_limbs(r2, n), one_limbs=to_limbs(R, n),
        )


@dataclass(frozen=True)
class CurveParams:
    name: str
    family: str          # 'bn' | 'bls12'
    u: int
    p: int               # base field modulus
    r: int               # group order (scalar field modulus)
    t: int               # trace of Frobenius
    b: int               # G1 curve: y^2 = x^3 + b
    h1: int              # G1 cofactor
    h2: int              # G2 cofactor
    modbytes: int        # serialized field-element width (MIRACL MODBYTES)
    g1: tuple            # G1 generator (x, y)
    g2: tuple            # G2 generator ((x0,x1),(y0,y1))
    qnr: int             # Fp2 = Fp[w]/(w^2 - qnr)
    xi: tuple            # sextic non-residue in Fp2 (tower + twist constant)
    twist: str           # 'D' (y^2 = x^3 + b/xi) or 'M' (y^2 = x^3 + b*xi)
    b2: tuple            # twist curve constant in Fp2
    fr_two_adicity: int  # v2(r - 1)
    fr_sylow_gen: int    # element of Fr* of order exactly 2^fr_two_adicity
    fp: FieldParams = field(default=None)
    fr: FieldParams = field(default=None)

    @property
    def order_bytes(self) -> int:
        """NumBytes(r) — reference kzg::CURVE_ORDER_BYTES."""
        return -(-self.r.bit_length() // 8)

    @property
    def max_chunk_bytes(self) -> int:
        """Reference MAX_CHUNK_BYTES macro."""
        return self.order_bytes - 1


@lru_cache(maxsize=None)
def get_curve(name: str) -> CurveParams:
    key = name.upper().replace("-", "").replace("_", "")
    if key not in CURVES:
        raise ValueError(f"unknown curve {name!r}; have {sorted(CURVES)}")
    d = dict(CURVES[key])
    d["fp"] = FieldParams.make(d["p"])
    d["fr"] = FieldParams.make(d["r"])
    return CurveParams(**d)


CURVE_NAMES = ("BN158", "BN254", "BLS12381")
# Curves the port runs end to end; the others' constants are data only.
PORTED_CURVES = ("BN254",)
