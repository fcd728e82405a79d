"""kzg_tpu_torch — the PyTorch/CUDA port of kzg_tpu.

KZG polynomial commitments over BN254, BLS12-381 and BN158 on an NVIDIA
H100: the protocol surface of ``kzg_tpu`` (init, blob, poly, commit,
proof, trusted_setup) with hand-written CUDA kernels for the Montgomery
multiply, the G1 and G2 complete add and doubling and the merge MSM's
combine (kzg_tpu_torch/csrc/, built per limb count: 17, 25 and 11). It imports torch and numpy, never jax and nothing of
``kzg_tpu``.

Quick start::

    import kzg_tpu_torch as kzg
    kzg.init("BN254")                   # the card; device="cpu" for plain torch
    ts = kzg.trusted_setup(128)
    b = kzg.blob.from_string("hello there")
    p = kzg.poly.from_blob(b)
    c = ts.create_commit(p)
    pi = ts.create_proof(p, 0, 5)                   # prove "hello"
    assert ts.verify_proof(c, pi, kzg.blob.from_string("hello", 0))
"""

from .protocol import api as _api
from .protocol.api import (blob, commit, init, poly, proof,  # noqa: F401
                           trusted_setup)


def __getattr__(name):
    # live module-level constants set by init() (mirrors kzg::CURVE_ORDER_BYTES)
    if name in ("CURVE_ORDER_BYTES", "MAX_CHUNK_BYTES"):
        return getattr(_api, name)
    raise AttributeError(name)
