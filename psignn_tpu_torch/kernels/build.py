"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into
``kernels/build/lib<name>_<hash>.so``, where the hash covers the source and
the flags, so an edited source rebuilds and an unchanged one loads the
existing library.  The sources expose plain C functions (no PyTorch
headers), which keeps a build to seconds.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register/shared-memory report)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on
    PATH; raises when none exists."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless the library for this source exists."""
    lib = library_path(name)
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n{log}")
    os.replace(tmp, lib)
    log_path.write_text(log)
    return BuildResult(lib, seconds, log)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name).path))
    return _LIBS[name]
