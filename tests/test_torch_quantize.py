"""The port's file quantizers (core/quantize.py), requantizer
(core/gguf.py requantize_gguf) and ``quantize`` verb against the JAX
package's. Every comparison is exact: the same encoder bytes, the same
output file byte for byte, the same per-tensor statistics and the same
printed lines (the timer's seconds and the output's path aside)."""

import re

import numpy as np
import pytest

from vision_tpu import cli as jcli
from vision_tpu.core import gguf as jgguf
from vision_tpu.core import quantize as jquantize
from vision_tpu_torch import cli as tcli
from vision_tpu_torch.core import gguf, quantize
from vision_tpu_torch.core.gguf import GGMLType, GGUFFile, GGUFValueType, GGUFWriter, requantize_gguf
from torch_threads import torch_threads  # noqa: F401

FORMATS = sorted(t.name for t in quantize.QUANTIZERS)
TYPES = list(gguf.REQUANTIZE_TYPES)


def test_quantizers_are_the_jax_packages():
    assert FORMATS == sorted(t.name for t in jquantize.QUANTIZERS)
    for name in FORMATS:
        assert quantize.block_size(GGMLType[name]) == jquantize.block_size(jgguf.GGMLType[name])


@pytest.mark.parametrize("name", FORMATS)
def test_quantize_blocks_bytes_equal_jax(name):
    """Gaussian rows with outliers, a constant block and a zero block: every
    encoder's bytes are the JAX package's."""
    block = quantize.block_size(GGMLType[name])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 2 * block)).astype(np.float32)
    x[1, :block] *= 40.0
    x[2, :block] = 0.25
    x[3, block:] = 0.0
    x[4] = np.abs(x[4])
    got = quantize.quantize_blocks(GGMLType[name], x)
    assert got == jquantize.quantize_blocks(jgguf.GGMLType[name], x)
    assert len(got) == x.size // block * gguf._DEQUANTIZE[GGMLType[name]][2]


def test_quantize_blocks_rejects_what_jax_rejects():
    from vision_tpu_torch.core.errors import VispError

    with pytest.raises(VispError, match="no encoder"):
        quantize.quantize_blocks(GGMLType.F16, np.zeros(32, np.float32))
    with pytest.raises(VispError, match="not a multiple of 32"):
        quantize.quantize_blocks(GGMLType.Q4_0, np.zeros(40, np.float32))


def _source_gguf(path) -> None:
    """A GGUF with what a requantize meets: floats that divide 256, floats
    that divide only 32, a ragged float, a 1-D bias, an integer table, a
    Q4_K payload, a Q8_0 payload, and KVs of wide types and arrays."""
    rng = np.random.default_rng(3)
    vec = np.load(__import__("pathlib").Path(__file__).parent / "fixtures" / "quant_vectors.npz")
    w = GGUFWriter(path, "esrgan")
    w.add("esrgan.scale", 4)
    w.add("esrgan.tensor_data_layout", "whcn")
    w.add("esrgan.big", 2**40, vtype=(GGUFValueType.UINT64, None))
    w.add("esrgan.ratio", 0.1, vtype=(GGUFValueType.FLOAT64, None))
    w.add("esrgan.layers", [1, 2, 3])
    w.add("esrgan.names", ["a", "bc"])
    w.add("general.file_type", 0)
    w.add_tensor("body.wide.weight", rng.standard_normal((8, 512)).astype(np.float32))
    w.add_tensor("body.narrow.weight", rng.standard_normal((4, 96)).astype(np.float32))
    w.add_tensor("body.conv.weight", rng.standard_normal((16, 8, 3, 3)).astype(np.float32))
    w.add_tensor("body.ragged", rng.standard_normal((6, 5)).astype(np.float32))
    w.add_tensor("body.bias", rng.standard_normal(64).astype(np.float32))
    w.add_tensor("body.index", np.arange(128, dtype=np.int32))
    w.add_tensor("body.half.weight", rng.standard_normal((2, 64)).astype(np.float16))
    w.add_raw_tensor("body.k.weight", (3, 256), GGMLType.Q4_K, vec["q4_k_raw"].tobytes())
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w.add_raw_tensor("body.q8.weight", x.shape, GGMLType.Q8_0, gguf.quantize_q8_0(x))
    w.write()


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    path = tmp_path_factory.mktemp("requantize") / "src.gguf"
    _source_gguf(path)
    return path


@pytest.mark.parametrize("float_type", TYPES)
def test_requantize_gguf_file_and_stats_equal_jax(source, tmp_path, float_type):
    mine, theirs = [], []
    out = requantize_gguf(source, tmp_path / "port.gguf", float_type, stats_out=mine)
    ref = jgguf.requantize_gguf(source, tmp_path / "jax.gguf", float_type, stats_out=theirs)
    assert out.read_bytes() == ref.read_bytes()
    assert mine == theirs and len(mine) == 9
    f = GGUFFile(out)
    assert f.metadata["general.file_type"] == gguf.REQUANTIZE_TYPES[float_type][0]
    assert f.metadata["esrgan.big"] == 2**40 and f.metadata["esrgan.names"] == ["a", "bc"]
    np.testing.assert_array_equal(f.tensor("body.index"), np.arange(128, dtype=np.int32))
    if float_type == "q8_0":  # already at the target type: the payload's bytes, copied
        assert bytes(f.raw("body.q8.weight")) == bytes(GGUFFile(source).raw("body.q8.weight"))
        assert ("body.q8.weight", "Q8_0", 0.0) in mine


def test_requantize_gguf_rejects_an_unknown_type(source, tmp_path):
    from vision_tpu_torch.core.errors import VispError

    with pytest.raises(VispError, match="unsupported float type 'q7'"):
        requantize_gguf(source, tmp_path / "x.gguf", "q7")


def _lines(text: str, dst) -> list[str]:
    """The verb's printed lines with its output path and timer seconds
    replaced."""
    text = text.replace(str(dst), "<out>")
    return re.sub(r"done \(\d+\.\d+s\)", "done (<s>)", text).splitlines()


@pytest.mark.parametrize("verify", [False, True], ids=["plain", "verify"])
@pytest.mark.parametrize("float_type", ["q8_0", "q4_1", "iq4_nl", "q4_k", "f16"])
def test_quantize_verb_equals_the_jax_clis(source, tmp_path, capsys, float_type, verify):
    args = ["quantize", "-m", str(source), "-t", float_type] + (["--verify"] if verify else [])
    assert tcli.main(args + ["-o", str(tmp_path / "port.gguf")]) == 0
    mine = _lines(capsys.readouterr().out, tmp_path / "port.gguf")
    assert jcli.main(args + ["-o", str(tmp_path / "jax.gguf")]) == 0
    theirs = _lines(capsys.readouterr().out, tmp_path / "jax.gguf")
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()
    assert mine == theirs
    assert mine[0] == f"Quantizing to {float_type}... done (<s>)" and mine[-1].startswith("-> <out> (")
    if verify:
        assert any("rel-rms" in ln for ln in mine) and any("(int, copied)" in ln for ln in mine)


def test_quantize_verb_names_its_output_beside_the_source(source, tmp_path, capsys):
    import shutil

    src = tmp_path / "m.gguf"
    shutil.copy(source, src)
    assert tcli.main(["quantize", "-m", str(src)]) == 0
    assert (tmp_path / "m-Q8_0.gguf").exists()
    assert f"-> {tmp_path / 'm-Q8_0.gguf'} (" in capsys.readouterr().out
    assert tcli.main(["quantize", "-m", str(tmp_path / "none.gguf")]) == 1
    assert "Model file not found" in capsys.readouterr().err
