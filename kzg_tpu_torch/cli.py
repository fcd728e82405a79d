"""kzg-cli: command-line interface with the reference's exact contract
(counterpart of kzg_tpu/cli.py).

    python -m kzg_tpu_torch.cli [--curve=NAME] setup N
                                             generate setup, export to kzg_public
    python -m kzg_tpu_torch.cli commit FILE  print hex commitment of FILE
    python -m kzg_tpu_torch.cli prove FILE SEED
                                             print "proofhex offset datahex"
    python -m kzg_tpu_torch.cli verify C P OFFSET DATA
                                             exit 0 if valid else 1

Curves: BN254 (the default), BLS12381, BN158. Same stdout formats and the
same `../shared/kzg_public` setup path, so the demo's bash protocol runs
unmodified against this CLI. It runs on the CUDA card; main(argv,
device="cpu") runs the plain PyTorch versions (tests).
"""

from __future__ import annotations

import sys
import time

import kzg_tpu_torch as kzg
from kzg_tpu_torch.protocol.serial import from_hex, to_hex

SETUP_PATH = "../shared/kzg_public"


def create_setup(num_coeff: int, curve: str, device=None):
    kzg.init(curve, device=device)
    t0 = time.time()
    ts = kzg.trusted_setup(num_coeff)
    dt = time.time() - t0
    print(f"KZG trusted setup generated in {dt}s")
    print(f"  num_coeff={num_coeff}")
    print(f"  max_commit_bytes={num_coeff * kzg.MAX_CHUNK_BYTES}")
    ts.export_setup()


def _load_file_padded(filename: str, chunk_size: int):
    with open(filename, "rb") as f:
        data = f.read()
    # the reference pads a whole chunk when the length is already a multiple
    zero_pad = chunk_size - (len(data) % chunk_size)
    return data + b"\x00" * zero_pad, len(data)


def _setup(curve: str, device=None):
    """The shared setup at SETUP_PATH, on `curve`."""
    kzg.init(curve, device=device)
    return kzg.trusted_setup(SETUP_PATH)


def commit_file(filename: str, curve: str, device=None):
    ts = _setup(curve, device)
    chunk_size = kzg.CURVE_ORDER_BYTES - 1
    data, _ = _load_file_padded(filename, chunk_size)
    b = kzg.blob.from_bytes(data, 0, len(data), chunk_size)
    p = kzg.poly.from_blob(b)
    c = ts.create_commit(p)
    print(to_hex(c.serialize()))


def create_proof(filename: str, seed: int, curve: str, device=None):
    ts = _setup(curve, device)
    chunk_size = kzg.MAX_CHUNK_BYTES
    data, raw_len = _load_file_padded(filename, chunk_size)
    b = kzg.blob.from_bytes(data, 0, len(data), chunk_size)
    p = kzg.poly.from_blob(b)
    chunk_length = raw_len // chunk_size
    random_chunk = seed % (chunk_length - 4)
    pr = ts.create_proof(p, random_chunk, 4)
    subsection = data[random_chunk * chunk_size:(random_chunk + 4) * chunk_size]
    print(f"{to_hex(pr.serialize())} {random_chunk} {to_hex(subsection)}")


def verify_proof(commit_hex: str, proof_hex: str, chunk_offset: int,
                 data_hex: str, curve: str, device=None) -> int:
    ts = _setup(curve, device)
    c = kzg.commit.deserialize(from_hex(commit_hex))
    pr = kzg.proof.deserialize(from_hex(proof_hex))
    chunk_size = kzg.MAX_CHUNK_BYTES
    byte_offset = chunk_offset * chunk_size
    byte_length = 4 * chunk_size
    b = kzg.blob.from_bytes(from_hex(data_hex), byte_offset, byte_length,
                            chunk_size)
    return 0 if ts.verify_proof(c, pr, b) else 1


def main(argv=None, device=None) -> int:
    """Run one command; `device` goes to init() (None: the card)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    curve = "BN254"
    if argv and argv[0].startswith("--curve="):
        curve = argv.pop(0).split("=", 1)[1]
    if not argv:
        print("usage: kzg-cli [--curve=NAME] "
              "{setup N | commit FILE | prove FILE SEED | "
              "verify C P OFFSET DATA}", file=sys.stderr)
        return 2
    cmd = argv[0]
    if cmd == "setup":
        create_setup(int(argv[1]), curve, device)
    elif cmd == "commit":
        commit_file(argv[1], curve, device)
    elif cmd == "prove":
        create_proof(argv[1], int(argv[2]), curve, device)
    elif cmd == "verify":
        return verify_proof(argv[1], argv[2], int(argv[3]), argv[4], curve,
                            device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
