"""Build and load the CUDA kernels (``csrc/*.cu``) with ``nvcc`` + ``ctypes``.

Each source compiles on its own into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

under ``build/repro_torch_kernels/`` at the repository root.  ``load``
and ``function`` also take another source directory (``src_dir``: the
auditor's allocator and fixtures, ``repro_torch/analysis``), whose
libraries go to a subdirectory named after it.  The file
name carries a hash of the source, the headers under ``csrc/`` and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.  Nothing here runs at import:
the first CUDA tensor that needs a kernel builds it (``load``), and
``build_all`` starts one ``nvcc`` per source at once.  The compiler's
``-Xptxas=-v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>-<hash>.log``.  ``require`` is the operand check
every wrapper runs before it hands pointers to a kernel.
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[Tuple[Path, str], ctypes.CDLL] = {}


def sources(src_dir: Optional[Path] = None) -> List[str]:
    """Kernel names: one per ``<src_dir>/<name>.cu`` (default ``csrc``)."""
    return sorted(p.stem for p in (src_dir or CSRC).glob("*.cu"))


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


def _target(name: str, src_dir: Optional[Path] = None) -> Path:
    """The library of ``<src_dir>/<name>.cu`` (default ``csrc``): its name
    hashes the source, every header beside it (any source may include
    them) and the flags."""
    src_dir = src_dir or CSRC
    h = hashlib.sha256((src_dir / f"{name}.cu").read_bytes())
    for header in sorted(src_dir.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_DIR if src_dir == CSRC else BUILD_DIR / src_dir.name
    return out_dir / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, src_dir: Optional[Path] = None) -> Tuple[subprocess.Popen, Path, Path]:
    """Start ``nvcc`` on one source; it writes a temporary file that
    ``_finish`` renames into place."""
    src_dir = src_dir or CSRC
    out = _target(name, src_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src_dir / f"{name}.cu")]
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


def build_all(*src_dirs: Path) -> float:
    """Compile every source of ``src_dirs`` (default ``csrc``) that has no
    current library, all ``nvcc`` processes at once; returns the seconds
    it took."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [(n, d) for d in (src_dirs or (CSRC,)) for n in sources(d)
                if not _target(n, d).exists()]
        jobs = {(n, d): _start(n, d) for n, d in todo}
        errors = []
        for (n, _), job in jobs.items():
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, src_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of ``<src_dir>/<name>.cu`` (default ``csrc``),
    built first if needed."""
    src_dir = src_dir or CSRC
    key = (src_dir, name)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            target = _target(name, src_dir)
            if not target.exists():
                _finish(name, _start(name, src_dir))
            lib = ctypes.CDLL(str(target))
            if hasattr(lib, "repro_error_string"):
                lib.repro_error_string.argtypes = [ctypes.c_int]
                lib.repro_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
    return lib


def function(name: str, symbol: str, argtypes: List[type],
             src_dir: Optional[Path] = None) -> Callable[..., None]:
    """A C entry point of ``<src_dir>/<name>.cu`` that returns a CUDA error
    code, wrapped to raise :class:`RuntimeError` when the code is not 0.

    Every pointer and the stream must be declared ``ctypes.c_void_p`` in
    ``argtypes``, or ctypes passes them as 32-bit ints.
    """
    lib = load(name, src_dir)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args) -> None:
        rc = fn(*args)
        if rc != 0:
            msg = lib.repro_error_string(rc).decode()
            raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")

    return call


def require(
    fn: str, t: torch.Tensor, name: str, dtype: torch.dtype, shape: Sequence[int],
    device: torch.device,
) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``; the message names the wrapper ``fn`` and the operand."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")
