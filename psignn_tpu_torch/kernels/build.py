"""Build the port's native libraries at first use and load them with
``ctypes``.

Two routes, chosen by the source's suffix in ``csrc/``: a CUDA kernel
``<name>.cu`` compiles with ``nvcc`` for ``sm_90a``; the host runtime
``<name>.cpp`` (``psignncore.cpp``, bound by ``psignn_tpu_torch/native.py``)
with the host's C++ compiler, ``$CXX`` or else ``g++``, at the flags of the
JAX package's ``native/Makefile``.  Either lands in
``kernels/build/lib<name>_<hash>.so``, where the hash covers the source,
the flags and, for the host route, the compiler and the host's CPU (the
flags hold ``-march=native``), so an edited source rebuilds and an
unchanged one loads the existing library.  The sources expose plain C
functions (no PyTorch headers), which keeps a build to seconds.  Nothing
here runs at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shlex
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# native/Makefile's CXXFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall"]
# /proc/cpuinfo's fields that key a -march=native build
CPU_FIELDS = ("model name", "cpu family", "model", "flags")

_LIBS: Dict[Path, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # the compiler's output (nvcc: the ptxas report)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on
    PATH; raises when none exists."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def find_cxx() -> str:
    """The host's C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def host_cpu() -> Dict[str, str]:
    """The first processor's ``CPU_FIELDS`` from ``/proc/cpuinfo`` (empty
    where there is none)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in CPU_FIELDS and key not in info:
                    info[key] = value.strip()
    except OSError:
        pass
    return info


def source(name: str) -> Path:
    """``csrc/<name>.cu`` or ``csrc/<name>.cpp``."""
    for suffix in (".cu", ".cpp"):
        path = SRC_DIR / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {name}.cu or {name}.cpp in {SRC_DIR}")


def _key(src: Path) -> List[str]:
    """What besides the source decides the library's bytes."""
    if src.suffix == ".cu":
        return NVCC_FLAGS
    key = [find_cxx(), *CXX_FLAGS]
    if "-march=native" in CXX_FLAGS:
        cpu = host_cpu()
        key += [cpu.get(field, "") for field in CPU_FIELDS]
    return key


def library_path(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_key(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless the library for this
    source exists.  A failed build raises ``RuntimeError`` with the
    compiler's command and output."""
    lib = library_path(name)
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, log)
    src = source(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    compiler = [find_nvcc(), *NVCC_FLAGS] if src.suffix == ".cu" \
        else [find_cxx(), *CXX_FLAGS]
    cmd = [*compiler, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"{shlex.join(cmd)}\ncould not run: {exc}") from exc
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{shlex.join(cmd)}\nfailed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    log_path.write_text(log)
    return BuildResult(lib, seconds, log)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, building it if
    needed."""
    path = library_path(name)
    if path not in _LIBS:
        _LIBS[path] = ctypes.CDLL(str(build(name).path))
    return _LIBS[path]
