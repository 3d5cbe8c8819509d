"""Error handling for vision_tpu_torch (a copy of vision_tpu/core/errors.py).

TPU-native analog of the reference's non-allocating exception type and
thread-local last-error used by its C ABI (reference: include/visp/util.h:51-61,
src/visp/c-api.cpp:6-21). In Python we keep a single exception class plus a
module-level last-error slot so the (optional) C ABI shim can mirror the
error-code + message discipline.
"""

from __future__ import annotations

import threading

__all__ = ["VispError", "raise_error", "set_last_error", "get_last_error"]

_tls = threading.local()


class VispError(RuntimeError):
    """Framework error. Mirrors `visp::exception` semantics."""


def raise_error(fmt: str, *args) -> None:
    msg = fmt.format(*args) if args else fmt
    set_last_error(msg)
    raise VispError(msg)


def set_last_error(msg: str) -> None:
    _tls.msg = msg


def get_last_error() -> str:
    return getattr(_tls, "msg", "")
