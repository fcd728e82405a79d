"""The proof-of-storage-for-payment demo against the port's CLI.

    python -m kzg_tpu_torch.demo

copies the repository's `demo/` into a temporary directory, replaces the
copy's `shared/kzg-cli` by a launcher of `kzg_tpu_torch.cli` (the repository
root on PYTHONPATH), runs the copy's `run-demo` (setup, peer A's host
request, peer B's acceptance, two hours of randomness, storage proof,
verification and payment) and prints its output; the exit code is the
demo's. `demo/` itself is never written to. It runs on the CUDA card;
run_demo(device="cpu") runs the CLI on the plain PyTorch versions.
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEMO = ROOT / "demo"


def _launcher(device) -> str:
    dev = None if device is None else str(device)
    code = ("import sys; from kzg_tpu_torch.cli import main; "
            f"sys.exit(main(device={dev!r}))")
    return ("#!/usr/bin/env bash\n"
            "# the demo's argv contract, served by kzg_tpu_torch.cli\n"
            f"exec {shlex.quote(sys.executable)} -c {shlex.quote(code)} "
            '"$@"\n')


def run_demo(device=None, timeout=None):
    """Run the demo on a copy of demo/; returns (exit code, output: stdout
    and stderr interleaved). The demo reads its sizes from the environment
    (SETUP_TERMS, 512 when unset)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory(prefix="kzg_demo_") as tmp:
        copy = Path(tmp) / "demo"
        shutil.copytree(DEMO, copy, ignore=shutil.ignore_patterns(
            "ledger", "kzg_public", "hosted_document"))
        cli = copy / "shared" / "kzg-cli"
        cli.write_text(_launcher(device))
        cli.chmod(0o755)
        out = subprocess.run(["bash", str(copy / "run-demo")], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=timeout)
    return out.returncode, out.stdout


def main() -> int:
    rc, out = run_demo()
    print(out, end="")
    return rc


if __name__ == "__main__":
    sys.exit(main())
