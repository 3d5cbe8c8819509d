"""Build and load the hand-written kernel library.

The CUDA sources in ``vision_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at the first
launch of any kernel, and loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library lands in ``build/vision_tpu_torch/`` beside
the package, under a name that carries a hash of the sources and flags, so an
edit rebuilds; a file lock keeps two processes from building at once. A
missing ``nvcc``, a failed build or a failed load raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "library_path", "build_info"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vision_tpu_torch"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the CUDA toolkit's default home
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the build reported: seconds it took (0.0 when the library was
# already built) and nvcc's output, which holds ptxas's register and
# spill counts per kernel
build_info: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvtt_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("vision_tpu_torch: nvcc not found; the CUDA kernels cannot be built")


def _build(path: Path) -> None:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(path) + ".tmp", *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"vision_tpu_torch: kernel build failed ({' '.join(cmd)}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(str(path) + ".tmp", path)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = res.stdout + res.stderr


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.vtt_flash_attention_fwd
    fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if path.exists():
                    build_info.setdefault("seconds", 0.0)
                    build_info.setdefault("log", "")
                else:
                    _build(path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"vision_tpu_torch: cannot load the kernel library {path}: {e}") from e
        _bind(lib)
        _lib = lib
        return lib
