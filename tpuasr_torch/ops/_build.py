"""Build and load the port's CUDA kernels and its host C++ library.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes``. The
build happens at first use, from the repository's sources only, into
``<repo>/build/``; the library's file name carries a hash of its source,
of the local headers it includes (``#include "x.cuh"``, followed
recursively) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded. Nothing here runs at import time.

``build_host``/``load_host`` do the same for a host C++ source (the
C++ beam search, ``decode/csrc/ctc_beam.cpp``) with the host compiler
``$CXX`` (default ``c++``, else ``g++``) and ``HOST_FLAGS``. Its name
also hashes the compiler and the CPU's instruction-set flags, since
``-march=native`` code built on one machine may not run on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native", "-shared")
HOST_LIBS = ("-lpthread",)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when reused), "log": the compiler's output}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, recursively,
    in the order first met."""
    found: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / m.decode()
                 for m in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return found


def _hashed(stem: str, paths: list[Path], flags: tuple) -> Path:
    h = hashlib.sha256()
    for path in paths:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    return _hashed(name, sources(name), NVCC_FLAGS)


def _compile(key: str, out: Path, command, tool: str) -> Path:
    """Run ``command(tmp)`` unless ``out`` exists, then move ``tmp`` in
    place (atomic: a concurrent loader never sees a torn file, and
    concurrent builders each write their own tmp). Raises with the
    compiler's output when the compile fails."""
    if out.exists():
        log = out.with_suffix(".log")
        build_info.setdefault(key, {
            "seconds": 0.0, "log": log.read_text() if log.exists() else ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(command(tmp), capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{tool} failed for {key}:\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    build_info[key] = {"seconds": seconds, "log": log}
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists.
    Raises with nvcc's output when the compile fails."""
    src = CSRC / f"{name}.cu"
    return _compile(name, library_path(name),
                    lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], "nvcc")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def _cxx() -> str:
    return os.environ.get("CXX") or shutil.which("c++") or "g++"


def _cpu_flags() -> str:
    """The CPU's instruction-set flags (what ``-march=native`` targets)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.processor()


def host_library_path(src: Path) -> Path:
    return _hashed(src.stem, [src], (_cxx(), *HOST_FLAGS, *HOST_LIBS, platform.machine(),
                                     _cpu_flags()))


def build_host(src: Path) -> Path:
    """Compile the host C++ source ``src`` into ``build/`` unless its
    library already exists. Raises with the compiler's output when the
    compile fails."""
    return _compile(src.name, host_library_path(src),
                    lambda tmp: [_cxx(), *HOST_FLAGS, "-o", str(tmp), str(src), *HOST_LIBS],
                    _cxx())


def load_host(src: Path) -> ctypes.CDLL:
    """The loaded library of the host C++ source ``src``, built on first
    use."""
    with _lock:
        lib = _libs.get(str(src))
        if lib is None:
            lib = _libs[str(src)] = ctypes.CDLL(str(build_host(src)))
        return lib
