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
    "vision_tpu_torch.core.graph",
    "vision_tpu_torch.core.params",
    "vision_tpu_torch.core.quant",
    "vision_tpu_torch.core.quantize",
    "vision_tpu_torch.core.weights",
    "vision_tpu_torch.image",
    "vision_tpu_torch.image.image",
    "vision_tpu_torch.image.png",
    "vision_tpu_torch.image.tiling",
    "vision_tpu_torch.ops",
    "vision_tpu_torch.ops.nn",
    "vision_tpu_torch.ops.deform",
    "vision_tpu_torch.ops.preprocess",
    "vision_tpu_torch.ops.resize",
    "vision_tpu_torch.ops.augment",
    "vision_tpu_torch.ops.cuda",
    "vision_tpu_torch.ops.cuda.build",
    "vision_tpu_torch.ops.cuda.flash_attention",
    "vision_tpu_torch.ops.cuda.window_attention",
    "vision_tpu_torch.ops.cuda.conv3x3",
    "vision_tpu_torch.ops.cuda.deform_sample",
    "vision_tpu_torch.ops.cuda.deform_conv",
    "vision_tpu_torch.ops.cuda.dequant",
    "vision_tpu_torch.ops.cuda.library",
    "vision_tpu_torch.ops.debug",
    "vision_tpu_torch.models",
    "vision_tpu_torch.models.dino",
    "vision_tpu_torch.models.depth_anything",
    "vision_tpu_torch.models.esrgan",
    "vision_tpu_torch.models.mobile_sam",
    "vision_tpu_torch.models.swin",
    "vision_tpu_torch.models.birefnet",
    "vision_tpu_torch.models.sam3",
    "vision_tpu_torch.models.yolov9t",
    "vision_tpu_torch.models.migan",
    "vision_tpu_torch.models.random_weights",
    "vision_tpu_torch.serve",
    "vision_tpu_torch.serve_http",
    "vision_tpu_torch.bulk",
    "vision_tpu_torch.video",
    "vision_tpu_torch.evaluate",
    "vision_tpu_torch.api",
    "vision_tpu_torch.lora",
    "vision_tpu_torch.train",
    "vision_tpu_torch.finetune",
    "vision_tpu_torch.cli",
    "vision_tpu_torch.convert",
    "vision_tpu_torch.convert.convert",
    "vision_tpu_torch.native",
    "vision_tpu_torch.utils",
    "vision_tpu_torch.utils.metrics",
    "vision_tpu_torch.utils.flops",
    "vision_tpu_torch.utils.profiling",
    "vision_tpu_torch.utils.dump",
    "vision_tpu_torch.export",
    "vision_tpu_torch.capi",
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


def test_backend_init_without_a_card_raises(monkeypatch):
    """With no argument the port takes the CUDA device or raises: it never
    falls back to the CPU unasked (the JAX package's policy differs)."""
    import pytest
    import torch

    from vision_tpu_torch.core.device import BackendType, backend_init
    from vision_tpu_torch.core.errors import VispError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VispError, match=r'backend_init\("cpu"\)'):
        backend_init()
    with pytest.raises(VispError):
        backend_init("gpu")
    assert backend_init("cpu").type == BackendType.cpu


def _tiny_gguf(tmp_path):
    import numpy as np

    from vision_tpu_torch.core.gguf import GGUFWriter, model_load

    w = GGUFWriter(tmp_path / "tiny.gguf", "esrgan")
    w.add_tensor("c.weight", np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2))
    w.add_tensor("c.index", np.arange(4, dtype=np.int32))
    w.write()
    return model_load(tmp_path / "tiny.gguf")


def test_load_weights_without_a_device_follows_backend_init(monkeypatch, tmp_path):
    """``load_weights(file)`` takes backend_init()'s device, as the model
    loaders do: with no card it raises the VispError that names
    backend_init("cpu"), and never puts the weights on the CPU unasked."""
    import pytest
    import torch

    from vision_tpu_torch.core.errors import VispError
    from vision_tpu_torch.core.weights import load_weights

    file = _tiny_gguf(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VispError, match=r'backend_init\("cpu"\)'):
        load_weights(file)


def test_load_weights_on_the_named_cpu(tmp_path):
    import numpy as np
    import torch

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.weights import load_weights

    params = load_weights(_tiny_gguf(tmp_path), backend_init("cpu"))
    assert params["c.weight"].device == torch.device("cpu") and params["c.weight"].dtype == torch.float32
    assert params["c.index"].device == torch.device("cpu") and not params["c.index"].is_floating_point()
    np.testing.assert_array_equal(params["c.weight"].numpy(), np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2))


def test_load_weights_as_numpy_needs_no_device(monkeypatch, tmp_path):
    import numpy as np
    import torch

    from vision_tpu_torch.core.weights import load_weights

    file = _tiny_gguf(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = load_weights(file, as_numpy=True)
    assert isinstance(arrays["c.weight"], np.ndarray) and arrays["c.weight"].dtype == np.float32
    np.testing.assert_array_equal(arrays["c.index"], np.arange(4, dtype=np.int32))
