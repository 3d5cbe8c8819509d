"""The port's converter (vision_tpu_torch/convert/convert.py) against the
JAX package's: the torch-twin checkpoints of tests/test_roundtrip.py, one
per architecture, each converted by both at f32, f16 and q8_0 (and in the
cwhn layout where the architecture permutes convs), must give the same
file, byte for byte."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_roundtrip import _biref_ckpt_names, build_sam_checkpoint
from vision_tpu.convert.convert import Writer as JWriter
from vision_tpu.convert.convert import convert_model as jax_convert_model
from vision_tpu_torch.convert import convert_model
from vision_tpu_torch.convert.convert import Writer
from vision_tpu_torch.core.gguf import GGUFFile
from workbench import randomize
from torch_threads import torch_threads  # noqa: F401


def _esrgan(d: Path) -> Path:
    from test_esrgan import RRDBNet

    torch.save(randomize(RRDBNet(nf=8, nb=1, gc=4, scale=4)).state_dict(), d / "esrgan.pth")
    return d / "esrgan.pth"


def _migan(d: Path) -> Path:
    from test_migan import TMigan

    torch.save(randomize(TMigan(res=16, ch=8)).state_dict(), d / "migan.pth")
    return d / "migan.pth"


def _depth_anything(d: Path) -> Path:
    from test_depth_anything import TDepthAnything

    torch.save(randomize(TDepthAnything()).state_dict(), d / "da.pth")
    return d / "da.pth"


def _yolov9t(d: Path) -> Path:
    from test_yolov9t import TYolo

    torch.save(randomize(TYolo()).state_dict(), d / "yolo.pth")
    return d / "yolo.pth"


def _sam(d: Path) -> Path:
    build_sam_checkpoint(d / "sam.pth")
    return d / "sam.pth"


def _birefnet(d: Path) -> Path:
    from test_birefnet import TBirefnet

    torch.save(_biref_ckpt_names(randomize(TBirefnet()).state_dict()), d / "birefnet-dynamic.pth")
    return d / "birefnet-dynamic.pth"


def _sam3(d: Path) -> Path:
    from test_sam3 import TClipText, TFpnLayer, TVit

    tokens = ["<unk>", "a", "b", "c", "a</w>", "b</w>", "c</w>", "ab", "ab</w>",
              "abc</w>", "1</w>", "!</w>", "<|startoftext|>", "<|endoftext|>"]
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    (d / "merges.txt").write_text("#version\na b\nab c</w>\na b</w>\n")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "bos_token_id": 12, "eos_token_id": 13, "pad_token_id": 13, "unk_token_id": 0, "model_max_length": 8,
    }))
    text = randomize(TClipText(vocab=14, dim=16, heads=4, layers=2, max_pos=8))
    vit = randomize(TVit(dim=8, heads=2, layers=3, patch=4, pretrain_grid=4, window=2, glob=(1,), img=16), seed=5)
    neck = [randomize(TFpnLayer(8, 4, i), seed=20 + i) for i in range(4)]
    ckpt = {}
    for k, v in text.state_dict().items():
        ckpt["detector_model.text_encoder.text_model." + k] = v
    for k, v in vit.state_dict().items():
        ckpt["detector_model.vision_encoder.backbone." + k] = v
    for i, lay in enumerate(neck):
        for k, v in lay.state_dict().items():
            ckpt[f"detector_model.vision_encoder.neck.fpn_layers.{i}." + k] = v
    torch.save(ckpt, d / "sam3.pth")
    return d / "sam3.pth"


CHECKPOINTS = {"esrgan": _esrgan, "migan": _migan, "depth-anything": _depth_anything, "yolov9t": _yolov9t,
               "sam": _sam, "birefnet": _birefnet, "sam3": _sam3}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    made = {}

    def get(arch: str) -> Path:
        if arch not in made:
            made[arch] = CHECKPOINTS[arch](tmp_path_factory.mktemp(arch.replace("-", "_")))
        return made[arch]

    return get


@pytest.mark.parametrize("float_type", [None, "f16", "q8_0"], ids=["f32", "f16", "q8_0"])
@pytest.mark.parametrize("arch", list(CHECKPOINTS))
def test_convert_model_file_equals_jax(checkpoint, tmp_path, arch, float_type):
    ckpt = checkpoint(arch)
    out = convert_model(arch, ckpt, tmp_path / "port.gguf", float_type)
    ref = jax_convert_model(arch, ckpt, tmp_path / "jax.gguf", float_type)
    assert out == tmp_path / "port.gguf"
    assert out.read_bytes() == ref.read_bytes()
    f = GGUFFile(out)
    assert f.tensors and f.metadata["general.file_type"] == {None: 0, "f16": 1, "q8_0": 7}[float_type]


@pytest.mark.parametrize("arch", ["esrgan", "migan", "depth-anything", "yolov9t"])
def test_convert_model_cwhn_layout_equals_jax(checkpoint, tmp_path, arch):
    ckpt = checkpoint(arch)
    out = convert_model(arch, ckpt, tmp_path / "port.gguf", "q8_0", layout="cwhn")
    ref = jax_convert_model(arch, ckpt, tmp_path / "jax.gguf", "q8_0", layout="cwhn")
    assert out.read_bytes() == ref.read_bytes()
    assert GGUFFile(out).tensor_layout == "cwhn"


def test_writer_ladder_equals_jax(tmp_path):
    """Writer with q4_k: 256-divisible rows K-quantize, 32-divisible ones
    fall back to q8_0, ragged and 1-D ones stay f32, as the JAX Writer."""
    rng = np.random.default_rng(5)
    arrays = {"a.weight": rng.standard_normal((4, 256)), "b.weight": rng.standard_normal((4, 96)),
              "c.ragged": rng.standard_normal((8, 5)), "d.bias": rng.standard_normal(24)}
    for cls, name in ((Writer, "port.gguf"), (JWriter, "jax.gguf")):
        w = cls(tmp_path / name, "testarch", "q4_k")
        for k, a in arrays.items():
            w.add_tensor(k, a.astype(np.float32))
        w.finish()
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()
    f = GGUFFile(tmp_path / "port.gguf")
    assert [f.tensors[k].ggml_type.name for k in arrays] == ["Q4_K", "Q8_0", "F32", "F32"]


def test_the_converter_module_runs_and_imports_no_jax(checkpoint, tmp_path):
    """``python -m vision_tpu_torch.convert.convert`` (the vision-convert-torch
    script) in a fresh interpreter: its file equals convert_model's, and it
    imports neither jax nor the JAX package."""
    ckpt = checkpoint("migan")
    code = ("import sys\nfrom vision_tpu_torch.convert.convert import main\n"
            f"sys.argv = ['vision-convert-torch', 'migan', {str(ckpt)!r}, '-o', {str(tmp_path / 'cli.gguf')!r}, "
            "'-q', 'q8_0']\nmain()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vision_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"-> {tmp_path / 'cli.gguf'}"
    ref = convert_model("migan", ckpt, tmp_path / "ref.gguf", "q8_0")
    assert (tmp_path / "cli.gguf").read_bytes() == ref.read_bytes()
