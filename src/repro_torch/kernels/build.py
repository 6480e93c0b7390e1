"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with :mod:`ctypes`; nothing includes
PyTorch's headers, so a build takes seconds.  The build happens at first
use, into ``build/repro_torch/<name>-<hash>.so`` at the repository root,
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header always rebuilds and an
unchanged one never does.  :func:`build_all` starts one
``nvcc`` per source at once; :func:`start_all` starts them without
waiting, and a later :func:`load` or :func:`build_all` waits for the
library it needs.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_contraction", "flash_attention", "quantized",
           "ssm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
#: wall seconds each library's build took in this process (0.0 = cached)
BUILD_SECONDS: dict[str, float] = {}
#: nvcc's output for each library built in this process: with ``-Xptxas
#: -v``, every kernel's registers, stack and spills
BUILD_LOGS: dict[str, str] = {}
#: nvcc runs started and not yet waited for: name -> (process, temporary
#: output, final path, start time)
_PENDING: dict[str, tuple] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``PATH``."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine that has the card")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def start_all(names=SOURCES) -> None:
    """Start ``nvcc`` for every library not built yet and not building,
    all at once, without waiting for them."""
    for name in names:
        if name not in _PENDING and not library_path(name).exists():
            _PENDING[name] = (*_start(name), time.perf_counter())


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every library not built yet, all ``nvcc`` runs at once (or
    wait for those :func:`start_all` started); returns the seconds each
    took (0.0 for one already built)."""
    start_all(names)
    for name in names:
        pending = _PENDING.pop(name, None)
        if pending is None:
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        proc, tmp, out, t0 = pending
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
    return {n: BUILD_SECONDS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
