"""Build and load the port's CUDA kernels and its host runtime.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with nvcc
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at
the repository root, then loaded with ctypes.  The library name carries a
hash of the source, of every header in ``csrc/`` (``*.cuh``) and of the
flags, so an edited source or header is rebuilt at its first use; nothing
is built at import time.

``csrc/<name>.cpp`` (the host runtime, ``ring.cpp``) is built the same way
with g++ (``build_host`` / ``load_host``).  Its flags name no host CPU
(no ``-march=native``): the checkout, build directory included, may move
between machines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    """The nvcc to use: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def host_library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(so: Path, cmd: list[str], tool: str, source: str) -> None:
    """Compile source with cmd into a temporary file beside so, then move
    it to so; raise with the compiler's stderr when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, source], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{tool} failed for {Path(source).name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists."""
    so = library_path(name)
    if so.exists():
        return so
    t0 = time.perf_counter()
    _compile(so, [nvcc(), *NVCC_FLAGS], "nvcc", str(CSRC / f"{name}.cu"))
    build_seconds[name] = time.perf_counter() - t0
    return so


def cxx() -> str:
    """The C++ compiler for the host runtime: $CXX, else g++ on PATH."""
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: set CXX to a C++17 compiler")
    return found


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with g++ unless its library exists."""
    so = host_library_path(name)
    if so.exists():
        return so
    t0 = time.perf_counter()
    _compile(so, [cxx(), *CXX_FLAGS], "g++", str(CSRC / f"{name}.cpp"))
    build_seconds[name] = time.perf_counter() - t0
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cpp, building it first if
    needed."""
    key = name + ".cpp"
    if key not in _loaded:
        _loaded[key] = ctypes.CDLL(str(build_host(name)))
    return _loaded[key]
