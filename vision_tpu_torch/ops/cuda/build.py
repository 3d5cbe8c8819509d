"""Build and load the hand-written kernel library.

The CUDA sources in ``vision_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and linked
into one shared library with a plain C interface, at the first launch of any
kernel; the library is loaded with ``ctypes`` (no PyTorch headers, so the
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise with the output of any that failed,
    after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, out) for c, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError(
            "vision_tpu_torch: kernel build failed:\n"
            + "\n".join(f"{' '.join(c)}\n{out}" for c, out in failed)
        )
    return "".join(outs)


def _build(path: Path) -> None:
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [Path(f"{path}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)])
    log += _run_all([[nvcc, "-shared", "-o", str(path) + ".tmp", *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(str(path) + ".tmp", path)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = log


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.vtt_flash_attention_fwd
    fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    fn = lib.vtt_window_attention_fwd
    fn.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    fn = lib.vtt_window_attention_plan
    fn.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = i
    fn = lib.vtt_conv3x3_fwd  # each size is checked below 2^31 by the wrapper
    q, f = ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [p, q, p, p, p, p, p, q, p, q, f, p, q, f, i, f, i, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.vtt_deform_sample_fwd  # B * Ho * Wo * kh * kw is checked below 2^31 by the wrapper
    fn.argtypes = [p, p, i, p, i, p, *([i] * 10), ctypes.c_float, i, p]
    fn.restype = i
    fn = lib.vtt_deform_conv_fwd  # the same rows, and H * W, are checked below 2^31 by the wrapper
    fn.argtypes = [p, p, i, i, p, i, p, i, p, p, p, i, i, p, q, *([i] * 10), f, i, i, p]
    fn.restype = i
    fn = lib.vtt_dequant_fwd  # n is checked below 2^31 by the wrapper; shape and stride are 4 host ints each
    fn.argtypes = [p, p, p, p, i, ctypes.POINTER(i), ctypes.POINTER(i), i, i, p]
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
