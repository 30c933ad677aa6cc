"""Build and load the CUDA kernels (``csrc/*.cu``) with ``nvcc`` + ``ctypes``.

Each source compiles on its own into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

under ``build/repro_torch_kernels/`` at the repository root.  The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs at import:
the first CUDA tensor that needs a kernel builds it (``load``), and
``build_all`` starts one ``nvcc`` per source at once.  The compiler's
``-Xptxas=-v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from source "
        "at first use and need the CUDA toolkit (tensors on the CPU take the "
        "plain PyTorch path and need no build)"
    )


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    """Start ``nvcc`` on one source; it writes a temporary file that
    ``_finish`` renames into place."""
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job: Tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)  # ptxas: registers, spills
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every source that has no current library, all ``nvcc``
    processes at once; returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in sources() if not _target(n).exists()]
        jobs = {n: _start(n) for n in todo}
        errors = []
        for n, job in jobs.items():
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _finish(name, _start(name))
            lib = ctypes.CDLL(str(target))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: List[type]) -> Callable[..., None]:
    """A C entry point of ``csrc/<name>.cu`` that returns a CUDA error code,
    wrapped to raise :class:`RuntimeError` when the code is not 0.

    Every pointer and the stream must be declared ``ctypes.c_void_p`` in
    ``argtypes``, or ctypes passes them as 32-bit ints.
    """
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args) -> None:
        rc = fn(*args)
        if rc != 0:
            msg = lib.repro_error_string(rc).decode()
            raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")

    return call
