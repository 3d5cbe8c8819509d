"""The native libraries of the port, each built with ``g++`` at first use:

* the host-ops library: the port's copy of the JAX package's native box
  blur and erosion (``host_ops.cpp`` here, from
  vision_tpu/native/host_ops.cpp), bound with ``ctypes``;
* the model-level C ABI (``c_api.cpp``, the port's copy of
  vision_tpu/native/c_api.cpp, importing ``vision_tpu_torch.capi``):
  :func:`build_capi` returns its path, for a C program to link or a
  ``ctypes`` caller to load. It compiles against this interpreter's
  ``Python.h`` (``sysconfig`` include dir) and links its ``libpython``
  (``LIBDIR``, ``LDVERSION``), as vision_tpu/native/Makefile does; a missing
  header or library raises.

Each source is compiled with ``g++`` at the first call into
``build/vision_tpu_torch/`` beside the package (gitignored), under a name
that carries a hash of the source and flags. The compiler writes to a name
of its own process and the file is renamed into place, so processes that
build at once each finish with a whole library. A missing compiler or a
failed build raises. The numpy forms in image/image.py are the plain
versions that the tests hold this library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

__all__ = ["box_blur", "build_capi", "capi_library_path", "erosion_f32", "library_path", "load_library"]

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
CAPI_SOURCE = Path(__file__).resolve().parent / "c_api.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vision_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libvtt_host-{h.hexdigest()[:16]}.so"


def _build(path: Path, source: Path = SOURCE, extra: tuple = ()) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"vision_tpu_torch: g++ not found; {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", tmp, *extra], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"vision_tpu_torch: {source.name} build failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)


def _python_flags() -> tuple[str, ...]:
    """The include and link flags of this interpreter's C API; raises when
    its ``Python.h`` or ``libpython`` is missing."""
    include = sysconfig.get_paths()["include"]
    libdir, ldversion = sysconfig.get_config_var("LIBDIR"), sysconfig.get_config_var("LDVERSION")
    if not (Path(include) / "Python.h").is_file():
        raise RuntimeError(f"vision_tpu_torch: Python.h not found in {include}; the C ABI cannot be built")
    if not libdir or not any(Path(libdir).glob(f"libpython{ldversion}.*")):
        raise RuntimeError(f"vision_tpu_torch: libpython{ldversion} not found in {libdir}; the C ABI cannot be "
                           f"built")
    return (f"-I{include}", f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ldversion}")


def capi_library_path() -> Path:
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *_python_flags())).encode() + CAPI_SOURCE.read_bytes())
    return BUILD_DIR / f"libvtt_capi-{h.hexdigest()[:16]}.so"


def build_capi() -> Path:
    """The C ABI's shared library (``visp_*`` symbols), built on first use;
    returns its path."""
    with _lock:
        path = capi_library_path()
        if not path.exists():
            _build(path, CAPI_SOURCE, _python_flags())
        return path


def load_library() -> ctypes.CDLL:
    """The host-ops library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            f32p, i = ctypes.POINTER(ctypes.c_float), ctypes.c_int
            lib.visp_box_blur.argtypes = [f32p, f32p, i, i, i, i]
            lib.visp_box_blur.restype = None
            lib.visp_erosion_f32.argtypes = [f32p, f32p, i, i, i]
            lib.visp_erosion_f32.restype = None
            _lib = lib
        return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check(shape, radius: int) -> None:
    if radius < 0 or int(np.prod(shape)) >= 2**31 or min(shape, default=0) < 1:
        raise ValueError(f"host ops: need a non-empty image below 2^31 elements and radius >= 0 "
                         f"(got {tuple(shape)}, radius {radius})")


def box_blur(src: np.ndarray, radius: int) -> np.ndarray:
    """(H, W, C) separable box blur of radius ``radius`` over the
    edge-replicated image, in f32 with f64 running sums."""
    src = np.ascontiguousarray(src, np.float32)
    _check(src.shape, radius)
    h, w, c = src.shape
    dst = np.empty_like(src)
    load_library().visp_box_blur(_fp(src), _fp(dst), h, w, c, radius)
    return dst


def erosion_f32(src: np.ndarray, radius: int) -> np.ndarray:
    """(H, W) or (H, W, 1) f32 min filter over the (2 radius + 1)^2
    neighbourhood of the edge-replicated image; returns (H, W)."""
    src = np.ascontiguousarray(src, np.float32)
    h, w = src.shape[:2]
    _check(src.shape, radius)
    if src.size != h * w:
        raise ValueError(f"erosion_f32: one channel only (got {src.shape})")
    dst = np.empty((h, w), np.float32)
    load_library().visp_erosion_f32(_fp(src), _fp(dst), h, w, radius)
    return dst
