"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface (raw pointers, ints and
the CUDA stream), so it compiles in seconds without PyTorch's headers.  A
build is keyed by a hash of the source and the compiler flags and lands in
``build/kernels/`` at the repository root (listed in ``.gitignore``); a
later process with the same source loads the existing library.  Nothing is
compiled when a module is imported: the first launch (or an explicit
:func:`build` / :func:`load`) builds.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``PATH`` first, then ``/usr/local/cuda``)."""
    exe = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {exe})")
    return exe


def library_path(source: Path) -> Path:
    """Where the build of ``source`` with the current flags lives."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: Path) -> Path:
    """Compile ``source`` for sm_90a unless a build of this exact source
    exists; return the library's path.  The compiler's ``-Xptxas -v`` report
    (registers, shared memory, spills per kernel) is kept beside the library
    as ``<name>.log``.  Processes on one host (the ranks of a process
    group) take a file lock on ``<stem>.lock`` in the build directory, so
    one of them compiles and the others load its library; the library also
    appears by an atomic rename, so a build that races one on another
    filesystem view is harmless.  Raises ``RuntimeError`` if ``nvcc``
    fails."""
    source = Path(source).resolve()
    lib_path = library_path(source)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{source.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when the file closes
        if not lib_path.exists():               # another process built it
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed on {source.name}:\n{proc.stdout}{proc.stderr}")
            lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)   # atomic: a reader sees all or nothing
    return lib_path


def load(source: Path) -> ctypes.CDLL:
    """:func:`build` ``source`` and load the library (once per process)."""
    source = Path(source).resolve()
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(build(source)))
        return _libs[source]
