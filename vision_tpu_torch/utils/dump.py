"""Golden-tensor dump and compare — the port of vision_tpu/utils/dump.py.

Any model can run inside a capture context (ops/debug.py) and the named
intermediates be dumped as .npy files, then compared dump to dump: the
same file names and collision rule as the JAX package's, so a dump of the
port and one of the JAX package compare file by file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["dump_captures", "compare_dumps"]


def dump_captures(captures: dict, out_dir: str | Path) -> list[str]:
    """Save a capture-context dict ({name: tensor or array}) as f32 .npy
    files; returns the paths written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    seen: dict[str, str] = {}
    for name, value in captures.items():
        safe = name.replace("/", "_").replace(".", "_")
        if safe in seen:
            # distinct capture names ('a.b' vs 'a_b') must not collapse onto
            # one file: a silent overwrite makes compare_dumps diff the wrong
            # tensor
            i = 2
            while f"{safe}__{i}" in seen:
                i += 1
            safe = f"{safe}__{i}"
        seen[safe] = name
        path = out / f"{safe}.npy"
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()  # bf16 becomes f32 on its device first
        np.save(path, np.asarray(value, dtype=np.float32))
        written.append(str(path))
    return written


def compare_dumps(dir_a: str | Path, dir_b: str | Path, rtol=1e-2, atol=1e-3) -> dict[str, dict]:
    """Layer-by-layer diff of two dump directories. Returns per-tensor
    stats: ``status`` (ok, mismatch, shape_mismatch, missing_in_a or
    missing_in_b) and, where shapes agree, max_abs, mean_abs and rms."""
    dir_a, dir_b = Path(dir_a), Path(dir_b)
    report = {}
    names = sorted(p.name for p in dir_a.glob("*.npy"))
    for name in names:
        pb = dir_b / name
        if not pb.exists():
            report[name] = {"status": "missing_in_b"}
            continue
        a = np.load(dir_a / name)
        b = np.load(pb)
        if a.shape != b.shape:
            report[name] = {"status": "shape_mismatch", "a": a.shape, "b": b.shape}
            continue
        diff = np.abs(a - b)
        ok = bool(np.allclose(a, b, rtol=rtol, atol=atol))
        report[name] = {
            "status": "ok" if ok else "mismatch",
            "max_abs": float(diff.max()),
            "mean_abs": float(diff.mean()),
            "rms": float(np.sqrt((diff**2).mean())),
        }
    for p in dir_b.glob("*.npy"):
        if p.name not in names:
            report[p.name] = {"status": "missing_in_a"}
    return report
