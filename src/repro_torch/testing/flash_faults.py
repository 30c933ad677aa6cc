"""Break the tensor-core flash kernel on purpose and show that the card's
checks notice.

Run from the root of a checkout, on a machine with one CUDA card::

    PYTHONPATH=src python3 -m repro_torch.testing.flash_faults

For each entry of :data:`FAULTS` it copies ``src/repro_torch`` into
``build/flash_faults/<fault>/``, makes that fault's edit to the copy's
``csrc/flash_attention.cu`` (``none`` makes no edit), and runs
``chip_smoke.check_flash`` (the usual cases) and
``chip_smoke.check_flash_peaked`` (the peaked cases) against the copy in a
process of its own, which builds the copy's kernel.  It prints one JSON
line per fault and check, ``passed`` true or false with the check's
message, and exits 0 only when the unchanged copy passes both checks and
every broken copy fails the peaked one.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

#: fault -> (text, replacement) edits of csrc/flash_attention.cu, each text
#: found exactly once in the tensor-core kernel.
FAULTS = {
    "none": [],
    # O is not rescaled when the running max grows (l still is).
    "no_rescale": [("o[i] *= c0;", "o[i] *= 1.0f;"), ("o[i + 1] *= c0;", "o[i + 1] *= 1.0f;"),
                   ("o[i + 2] *= c1;", "o[i + 2] *= 1.0f;"), ("o[i + 3] *= c1;", "o[i + 3] *= 1.0f;")],
    # exp2 of the scores themselves: no running max is subtracted.
    "no_max": [("    const float c0 = exp2f(m0 - mx0);",
                "    mx0 = 0.0f;\n    mx1 = 0.0f;\n    const float c0 = exp2f(m0 - mx0);")],
    # Each thread keeps the max of its own columns: no quad shuffle.
    "no_quad_max": [("for (int off = 1; off <= 2; off <<= 1) {\n      mx0",
                     "for (int off = 1; off <= 0; off <<= 1) {\n      mx0")],
}

_CHILD = """
import json, sys
import torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import chip_smoke
from repro_torch.kernels import ops
torch.backends.cuda.matmul.allow_tf32 = False
for check in ("check_flash", "check_flash_peaked"):
    try:
        getattr(chip_smoke, check)(torch, ops, torch.device("cuda"))
        row = {"passed": True}
    except AssertionError as e:
        row = {"passed": False, "message": str(e)}
    print(json.dumps({"fault": sys.argv[3], "check": check, **row}), flush=True)
"""


def apply_fault(text: str, fault: str) -> str:
    """``text`` (the flash source) with ``fault``'s edits made; raises if
    an edit's text is not found exactly once."""
    for old, new in FAULTS[fault]:
        if text.count(old) != 1:
            raise ValueError(f"{fault}: {old!r} is not found exactly once in the flash source")
        text = text.replace(old, new)
    return text


def make_copy(fault: str) -> Path:
    """``build/flash_faults/<fault>`` holding ``repro_torch`` with the
    fault's edits; returns the directory to put first on ``sys.path``."""
    dest = ROOT / "build" / "flash_faults" / fault
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dest / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
    cu.write_text(apply_fault(cu.read_text(), fault))
    return dest


def main() -> int:
    results = {}
    for fault in FAULTS:
        src = make_copy(fault)
        proc = subprocess.run([sys.executable, "-c", _CHILD, str(src), str(ROOT), fault],
                              capture_output=True, text=True, timeout=900, cwd=ROOT)
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"fault"')]
        if proc.returncode or len(rows) != 2:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"{fault}: the checks did not run to the end (exit {proc.returncode})")
        for row in rows:
            print(json.dumps(row), flush=True)
            results[fault, row["check"]] = row["passed"]
    ok = results["none", "check_flash"] and results["none", "check_flash_peaked"]
    ok = ok and not any(results[f, "check_flash_peaked"] for f in FAULTS if f != "none")
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
