"""The port imports neither jax nor the JAX package. The suite's conftest
imports jax into every test process, so the check runs in a subprocess."""

import subprocess
import sys
from pathlib import Path

SLICE_MODULES = [
    "vision_tpu_torch",
    "vision_tpu_torch.core",
    "vision_tpu_torch.core.device",
    "vision_tpu_torch.core.errors",
    "vision_tpu_torch.core.gguf",
    "vision_tpu_torch.core.params",
    "vision_tpu_torch.core.weights",
    "vision_tpu_torch.image",
    "vision_tpu_torch.image.image",
    "vision_tpu_torch.ops",
    "vision_tpu_torch.ops.nn",
    "vision_tpu_torch.ops.preprocess",
    "vision_tpu_torch.ops.resize",
    "vision_tpu_torch.ops.cuda",
    "vision_tpu_torch.ops.cuda.build",
    "vision_tpu_torch.ops.cuda.flash_attention",
    "vision_tpu_torch.models",
    "vision_tpu_torch.models.dino",
    "vision_tpu_torch.models.depth_anything",
    "vision_tpu_torch.models.random_weights",
    "vision_tpu_torch.serve",
]


def test_port_imports_neither_jax_nor_vision_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vision_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code],
        cwd=Path(__file__).resolve().parents[1],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr


def test_backend_init_cpu_policy(monkeypatch):
    import pytest
    import torch

    from vision_tpu_torch.core.device import BackendType, BuildFlag, backend_init
    from vision_tpu_torch.core.errors import VispError

    monkeypatch.delenv("VISP_FLASH_ATTENTION", raising=False)
    dev = backend_init("cpu")
    assert dev.type == BackendType.cpu and dev.torch_device == torch.device("cpu")
    assert dev.preferred_float_type == torch.float32 and dev.flags == BuildFlag.none
    monkeypatch.setenv("VISP_FLASH_ATTENTION", "1")  # the reference's override
    assert backend_init("cpu").flags & BuildFlag.flash_attention
    with pytest.raises(VispError, match="unknown backend"):
        backend_init("tpu")
