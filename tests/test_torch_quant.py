"""Quantized residency in the port (core/quant.py, core/gguf.py's integer
decomposition, ops/cuda/dequant.py's plain version, the loaders'
keep_quantized path) against the JAX package's.

Tolerances: integer levels, scales, file bytes and dequantized weights are
exact (the plain dequant makes the same f32 product and sum and the same
round-to-nearest-even cast as the JAX package's and the expanded load's).
A port model loaded resident at f32 on the CPU must give a forward bit-equal
to its expanded load of the same file; against the JAX package's resident
load it keeps the family's port-vs-JAX tolerance (tests/test_torch_api.py
REL_RMS, tests/test_torch_yolov9t.py ATOL / RTOL). The store bound is the
JAX package's (tests/test_quant.py: resident < 0.55x expanded)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_api import _compute, _rel_rms, sample_image, write_family_gguf
from vision_tpu import api as japi
from vision_tpu.core import gguf as jgguf
from vision_tpu.core import quant as jquant
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.params import Params as JParams
from vision_tpu.core.weights import load_weights as jax_load_weights
from vision_tpu.image import Image as JaxImage
from vision_tpu.image import ImageFormat as JaxImageFormat
from vision_tpu.models import yolov9t as jyolo
from vision_tpu_torch import api
from vision_tpu_torch.core import gguf
from vision_tpu_torch.core import quant
from vision_tpu_torch.core.device import BuildFlag, backend_init
from vision_tpu_torch.core.gguf import GGMLType, GGUFWriter, model_load, requantize_gguf
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.quant import QuantResident, is_quant, store_nbytes
from vision_tpu_torch.core.weights import cast_float_params, load_weights, params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models import yolov9t as yolo
from vision_tpu_torch.models.random_weights import random_yolov9t_params
from vision_tpu_torch.ops.cuda import dequant as dq
from torch_threads import torch_threads  # noqa: F401

FIXTURES = Path(__file__).parent / "fixtures"
RESIDENT = ["Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "IQ4_NL", "IQ4_XS"]
YOLO_ATOL, YOLO_RTOL = 1e-5, 1e-4  # tests/test_torch_yolov9t.py: f32 sums taken in another order


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # defines only; main() is not run
    return module


def _raw_blocks(fmt: GGMLType, nb: int, rng) -> bytes:
    """Valid random payloads of ``nb`` blocks (as tests/test_quant.py)."""

    def f16(vals):
        return np.asarray(vals, np.float16).reshape(-1, 1).view(np.uint8)

    d, m = f16(rng.standard_normal(nb) * 0.1), f16(rng.standard_normal(nb) * 0.05)
    qs16 = rng.integers(0, 256, (nb, 16), dtype=np.uint8)
    qh = rng.integers(0, 256, (nb, 4), dtype=np.uint8)
    q32 = rng.integers(-127, 128, (nb, 32)).astype(np.int8).view(np.uint8)
    parts = {
        GGMLType.Q8_0: [d, q32], GGMLType.Q4_0: [d, qs16], GGMLType.Q4_1: [d, m, qs16],
        GGMLType.Q5_0: [d, qh, qs16], GGMLType.Q5_1: [d, m, qh, qs16], GGMLType.IQ4_NL: [d, qs16],
    }
    if fmt == GGMLType.IQ4_XS:
        parts[fmt] = [d, rng.integers(0, 256, (nb, 2), dtype=np.uint8), rng.integers(0, 256, (nb, 4), dtype=np.uint8),
                      rng.integers(0, 256, (nb, 128), dtype=np.uint8)]
    return np.concatenate(parts[fmt], axis=1).tobytes()


def _n_elements(fmt: GGMLType, nb: int) -> int:
    return nb * (256 if fmt == GGMLType.IQ4_XS else 32)


def _bits(a) -> np.ndarray:
    """A float array's bits (bf16 as u16, f32 as u32), for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        return a.view(np.uint16) if a.dtype == np.int16 else a.view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def test_resident_types_are_the_jax_packages():
    assert {t.name for t in gguf._RESIDENT_TYPES} == {t.name for t in jgguf._RESIDENT_TYPES} == set(RESIDENT)
    assert {k: (c, None if t is None else t.name) for k, (c, t) in gguf.REQUANTIZE_TYPES.items()} == {
        k: (c, None if t is None else t.name) for k, (c, t) in jgguf.REQUANTIZE_TYPES.items()}
    assert quant._CONV_KERNEL_SIZES == jquant._CONV_KERNEL_SIZES


@pytest.mark.parametrize("name", RESIDENT)
def test_quant_blocks_equal_jax_on_the_fixture(name):
    """tests/fixtures/quant_vectors.npz's payloads: the same arrays, and
    q * scale (+ minv) is the fixture's expected dequant, bit for bit."""
    vec = np.load(FIXTURES / "quant_vectors.npz")
    raw, expected = vec[f"{name.lower()}_raw"].tobytes(), vec[f"{name.lower()}_expected"]
    got = gguf.quant_blocks(GGMLType[name], raw, expected.size)
    want = jgguf.quant_blocks(jgguf.GGMLType[name], raw, expected.size)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    q, scale, minv = got
    back = dq.dequant_plain(torch.from_numpy(q), torch.from_numpy(scale),
                            None if minv is None else torch.from_numpy(minv), (q.size,), None, torch.float32)
    np.testing.assert_array_equal(_bits(back), _bits(expected))


@pytest.mark.parametrize("name", RESIDENT)
def test_quant_blocks_equal_jax_on_random_blocks(name):
    fmt = GGMLType[name]
    raw = _raw_blocks(fmt, 9, np.random.default_rng(4))
    n = _n_elements(fmt, 9)
    for a, b in zip(gguf.quant_blocks(fmt, raw, n), jgguf.quant_blocks(jgguf.GGMLType[name], raw, n)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_quantize_q8_0_rounds_ties_away_from_zero_as_jax():
    x = np.array([0.5, -0.5, 1.5, -1.5, 2.5, 127.0] + [0.0] * 26, np.float32)  # d = 1: exact ties
    assert gguf.quantize_q8_0(x) == jgguf.quantize_q8_0(x)
    q, d = gguf.q8_0_block_levels(x)
    assert list(q[0, :6]) == [1, -1, 2, -2, 3, 127] and d[0] == 1.0
    rng = np.random.default_rng(1)
    y = rng.standard_normal((16, 64)).astype(np.float32)
    assert gguf.quantize_q8_0(y) == jgguf.quantize_q8_0(y)
    for a, b in zip(gguf.q8_0_block_levels(y, 256), jgguf.q8_0_block_levels(y, 256)):
        np.testing.assert_array_equal(a, b)


def _conv_gguf(path, name: str, layout: str, with_list: bool, seed: int = 2):
    """A GGUF of one resident-format tensor of each kind: a linear, a conv
    and a depthwise conv stored in ``layout`` (cwhn: (O,H,W,I), (H,W,1,C)),
    a f32 bias and an int table; with ``with_list`` the conv2d_weights list
    names the two convs."""
    fmt = GGMLType[name]
    rng = np.random.default_rng(seed)
    block = 256 if fmt == GGMLType.IQ4_XS else 32
    shapes = {
        "body.lin.weight": (6, 2 * block),
        "body.conv.weight": (4, 3, 3, 2 * block) if layout == "cwhn" else (4, 2 * block, 3, 3),
        "body.dw.weight": (3, 3, 1, 2 * block) if layout == "cwhn" else (2 * block, 1, 3, 3),
    }
    w = GGUFWriter(path, "testarch")
    w.add("testarch.tensor_data_layout", layout)
    for k, shape in shapes.items():
        n = int(np.prod(shape))
        w.add_raw_tensor(k, shape, fmt, _raw_blocks(fmt, n // block, rng))
    w.add_tensor("body.lin.bias", rng.standard_normal(6).astype(np.float32))
    w.add_tensor("body.index", np.arange(8, dtype=np.int32))
    if with_list:
        w.add("testarch.conv2d_weights", [1, 2])
    w.write()


@pytest.mark.parametrize("layout,with_list", [("whcn", False), ("cwhn", False), ("cwhn", True)],
                         ids=["whcn", "cwhn", "cwhn_conv2d_list"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", RESIDENT)
def test_plain_dequant_is_jax_and_the_expanded_load(tmp_path, name, dtype, layout, with_list):
    """QuantResident.dequant on the CPU (ops/cuda/dequant.py's plain form),
    bit for bit: the JAX package's QuantResident.dequant of the same file,
    and the port's expanded load rounded to the same type. A conv2d_weights
    list un-permutes only in cwhn files, as in the JAX package."""
    path = tmp_path / "q.gguf"
    _conv_gguf(path, name, layout, with_list)
    tdtype = getattr(torch, dtype)
    mine = load_weights(model_load(path), backend_init("cpu"), float_dtype=tdtype, keep_quantized=True)
    theirs = jax_load_weights(jgguf.model_load(path), None, float_dtype=jnp.dtype(dtype), keep_quantized=True)
    expanded = load_weights(model_load(path), backend_init("cpu"), float_dtype=tdtype)
    assert set(mine) == set(theirs) == set(expanded)
    for k in ("body.lin.weight", "body.conv.weight", "body.dw.weight"):
        r, j = mine[k], theirs[k]
        assert is_quant(r) and jquant.is_quant(j)
        assert r.permute == j.permute and r.file_shape == j.file_shape and r.shape == j.shape
        out = r.dequant()
        assert out.dtype == tdtype and out.is_contiguous() and tuple(out.shape) == tuple(expanded[k].shape)
        np.testing.assert_array_equal(_bits(out), _bits(np.asarray(j.dequant())))
        np.testing.assert_array_equal(_bits(out), _bits(expanded[k]))
    if layout == "cwhn":
        assert mine["body.conv.weight"].permute == (0, 3, 1, 2) and mine["body.dw.weight"].permute == (3, 2, 0, 1)
    for k in ("body.lin.bias", "body.index"):
        assert not is_quant(mine[k])
        np.testing.assert_array_equal(mine[k].float().numpy(), np.asarray(theirs[k], np.float32))


def test_k_quants_expand_even_with_keep_quantized(tmp_path):
    vec = np.load(FIXTURES / "quant_vectors.npz")
    path = tmp_path / "k.gguf"
    w = GGUFWriter(path, "testarch")
    w.add_raw_tensor("a.weight", (3, 256), GGMLType.Q4_K, vec["q4_k_raw"].tobytes())
    w.write()
    f = model_load(path)
    assert f.is_quantized("a.weight") and f.tensor_quant_blocks("a.weight") is None
    out = load_weights(f, backend_init("cpu"), keep_quantized=True)["a.weight"]
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), vec["q4_k_expected"].reshape(3, 256))


def test_numpy_resident_moves_once_and_keeps_its_numbers(tmp_path):
    """load_weights(as_numpy) keeps numpy-backed residents; params_from_numpy
    moves them and retargets their dtype; cast_float_params passes them by."""
    path = tmp_path / "q.gguf"
    _conv_gguf(path, "Q4_1", "cwhn", False)
    host = load_weights(model_load(path), as_numpy=True, keep_quantized=True)
    r = host["body.conv.weight"]
    assert isinstance(r.q, np.ndarray) and r.dtype == torch.float32 and r.minv is not None
    moved = params_from_numpy(host, "cpu", torch.bfloat16)
    m = moved["body.conv.weight"]
    assert isinstance(m.q, torch.Tensor) and m.dtype == torch.bfloat16 and m.q.dtype == torch.int8
    assert cast_float_params(moved, torch.float32)["body.conv.weight"] is m
    np.testing.assert_array_equal(_bits(m.dequant()), _bits(r.dequant().to(torch.bfloat16)))
    assert m.nbytes == r.nbytes == m.q.numel() + 4 * m.scale.numel() + 4 * m.minv.numel()
    assert m.astype(torch.float32).dtype == torch.float32 and m.astype(torch.float32).q is m.q


def test_params_find_dequantizes_as_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    store = {"blk.w": quant.quantize_resident(a, torch.float32), "blk.b": torch.zeros(16)}
    jstore = {"blk.w": jquant.quantize_resident(a, "float32"), "blk.b": np.zeros(16, np.float32)}
    got = Params(store)["blk"].weight("w")
    want = np.asarray(JParams(jstore)["blk"].weight("w"))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert Params(store)["blk"].find("b") is store["blk.b"] and Params(store).find("none") is None


def test_quantize_store_and_store_nbytes_equal_jax():
    rng = np.random.default_rng(5)
    arrays = {
        "enc.big.weight": rng.standard_normal((64, 128)).astype(np.float32),
        "enc.small.weight": rng.standard_normal((8, 32)).astype(np.float32),  # under min_elements
        "enc.ragged.weight": rng.standard_normal((65, 65)).astype(np.float32),  # not a multiple of 32
        "enc.positional.table": rng.standard_normal((64, 64)).astype(np.float32),  # skipped by name
        "enc.index": np.arange(8192, dtype=np.int64),  # not a float
    }
    mine = quant.quantize_store({k: torch.from_numpy(v) for k, v in arrays.items()}, torch.bfloat16)
    theirs = jquant.quantize_store(dict(arrays), "bfloat16")
    assert {k for k, v in mine.items() if is_quant(v)} == {k for k, v in theirs.items() if jquant.is_quant(v)} \
        == {"enc.big.weight"}
    r, j = mine["enc.big.weight"], theirs["enc.big.weight"]
    np.testing.assert_array_equal(r.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(r.scale.numpy(), np.asarray(j.scale))
    assert r.minv is None and j.minv is None and r.dtype == torch.bfloat16 and r.q.device == torch.device("cpu")
    assert store_nbytes(mine) == jquant.store_nbytes(theirs)
    np.testing.assert_array_equal(_bits(r.dequant()), _bits(np.asarray(j.dequant())))
    host = quant.quantize_store(dict(arrays), torch.float32)
    assert isinstance(host["enc.big.weight"].q, np.ndarray) and store_nbytes(host) == store_nbytes(mine)


def test_unpermute_cwhn_follows_the_jax_heuristic():
    cases = [("a.weight", (8, 3, 3, 32), False), ("a.weight", (3, 3, 1, 32), False), ("a.weight", (8, 5, 5, 32), False),
             ("a.weight", (8, 5, 5, 32), True), ("a.bias", (8, 3, 3, 32), False), ("a.weight", (64, 32), False)]
    for name, shape, trusted in cases:
        n = int(np.prod(shape))
        r = QuantResident(np.zeros(n, np.int8), np.ones(n // 32, np.float32), None, shape, None, torch.float32)
        j = jquant.QuantResident(np.zeros(n, np.int8), np.ones(n // 32, np.float32), None, shape, None, "float32")
        if len(shape) != 4 and trusted:
            continue
        assert r.unpermute_cwhn(name, trusted).permute == j.unpermute_cwhn(name, trusted).permute
        assert r.unpermute_cwhn(name, trusted).shape == j.unpermute_cwhn(name, trusted).shape


@pytest.mark.parametrize("permute,file_shape", [
    (None, (6, 64)), ((0, 3, 1, 2), (4, 3, 3, 64)), ((3, 2, 0, 1), (3, 3, 1, 64)), ((1, 0), (32, 5)),
    ((2, 0, 1), (2, 3, 32)),
])
def test_kernel_source_offsets_reproduce_the_permute(permute, file_shape):
    """The permuted kernel reads q at sum(c_d * stride_d) over the output's
    coordinates (csrc/dequant.cu dequant_permute_kernel); the shape and
    strides the wrapper hands it must address what the plain permute
    reads."""
    perm = permute or tuple(range(len(file_shape)))
    shape, stride = dq._source_strides(file_shape, perm)
    n = int(np.prod(file_shape))
    src = np.arange(n).reshape(file_shape).transpose(perm).reshape(-1)
    got = []
    for i in range(n):  # the kernel's loop, one output element a thread
        rest, off = i, 0
        for d in (3, 2, 1, 0):
            c = rest % shape[d]
            rest //= shape[d]
            off += c * stride[d]
        got.append(off)
    np.testing.assert_array_equal(got, src)


def test_dequant_checks_what_the_kernel_takes():
    q, s = torch.zeros(64, dtype=torch.int8), torch.ones(2)
    ok = dict(minv=None, file_shape=(2, 32), permute=None, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int8"):
        dq._check(q.float(), s, **ok)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dq._check(q, s, **{**ok, "dtype": torch.float16})
    with pytest.raises(ValueError, match="file shape"):
        dq._check(q, s, **{**ok, "file_shape": (4, 32)})
    with pytest.raises(ValueError, match="scales"):
        dq._check(q, torch.ones(3), **ok)
    with pytest.raises(ValueError, match="permutation"):
        dq._check(q, s, **{**ok, "permute": (0, 0)})
    with pytest.raises(ValueError, match="at most 4"):
        dq._check(q, s, **{**ok, "file_shape": (2, 2, 2, 2, 4)})
    with pytest.raises(ValueError, match="CUDA"):  # everything else holds: a CPU tensor is the one fault
        dq._check(q, s, **ok)


def test_dequant_on_the_cpu_is_the_plain_form_and_counts_no_launch():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.integers(-127, 128, 4 * 3 * 3 * 64).astype(np.int8))
    s, m = torch.from_numpy(rng.random(72).astype(np.float32)), torch.from_numpy(rng.random(72).astype(np.float32))
    before = dq.launches
    out = dq.dequant(q, s, m, (4, 3, 3, 64), (0, 3, 1, 2), torch.bfloat16)
    assert dq.launches == before and out.is_contiguous() and out.shape == (4, 64, 3, 3)
    ref = ((q.reshape(-1, 32).float() * s[:, None] + m[:, None]).reshape(4, 3, 3, 64)
           .permute(0, 3, 1, 2).to(torch.bfloat16))
    assert torch.equal(out, ref)


def test_keep_quantized_is_off_by_default_and_follows_the_env(monkeypatch):
    monkeypatch.delenv("VISP_KEEP_QUANT", raising=False)
    assert not backend_init("cpu").flags & BuildFlag.keep_quantized
    monkeypatch.setenv("VISP_KEEP_QUANT", "1")
    assert backend_init("cpu").flags & BuildFlag.keep_quantized
    monkeypatch.setenv("VISP_KEEP_QUANT", "off")
    assert not backend_init("cpu").flags & BuildFlag.keep_quantized


# -- the five families with a resident path --

RESIDENT_FAMILIES = ["depthany", "birefnet", "sam", "migan", "yolov9t"]
# stored cwhn before the Q8_0 copy, so that their 3x3 convs' rows (the
# input channels) divide the 32-block; the others' files are quantized as
# they are
CWHN = {"depthany", "migan", "yolov9t"}


def _q8_file(family: str, tmp_path, chip_smoke) -> str:
    if family == "yolov9t":  # at full width: the small twin's 16- and 24-channel convs stay f32
        src = tmp_path / "yolov9t.gguf"
        w = GGUFWriter(src, "yolov9t")
        for k, a in random_yolov9t_params(0).items():
            w.add_tensor(k, a)
        w.write()
        src = str(src)
    else:
        src = write_family_gguf(family, tmp_path)
    if family in CWHN:
        chip_smoke.cwhn_gguf(src, str(tmp_path / f"{family}-cwhn.gguf"))
        src = str(tmp_path / f"{family}-cwhn.gguf")
    return str(requantize_gguf(src, tmp_path / f"{family}-q8_0.gguf", "q8_0"))


def _forward(model, family: str):
    """The family's raw forward on a seeded input at a small extent: one
    tensor or a tuple of them."""
    rng = np.random.default_rng(11)
    if family == "sam":
        x = torch.from_numpy(rng.integers(0, 256, (1, 1024, 1024, 3), dtype=np.uint8))
        emb = model.encode_u8(x)
        pred = model.decode(emb, np.array([[[500.0, 400.0], [0.0, 0.0]]], np.float32), "point")
        return emb, pred.masks, pred.iou
    side = {"depthany": 126, "birefnet": 64, "migan": 64, "yolov9t": 64}[family]
    x = torch.from_numpy(rng.integers(0, 256, (1, side, side, 3), dtype=np.uint8))
    if family == "migan":
        m = torch.from_numpy(rng.integers(0, 2, (1, side, side, 1), dtype=np.uint8) * 255)
        return model._forward_u8(x, m)
    out = model._forward_u8(x)
    return tuple(out) if family == "yolov9t" else out


@pytest.mark.parametrize("family", RESIDENT_FAMILIES)
def test_resident_family_is_bit_equal_to_its_expanded_load(family, tmp_path, chip_smoke):
    """The same Q8_0 file loaded resident and expanded at CPU f32: the same
    forward, bit for bit, and the resident store below 0.55x the expanded
    one (tests/test_quant.py's bound)."""
    path = _q8_file(family, tmp_path, chip_smoke)
    dev = backend_init("cpu")
    exp = api.load_model(path, dev)
    res = api.load_model(path, dev.with_flags(dev.flags | BuildFlag.keep_quantized))
    residents = [k for k, v in res.params.items() if is_quant(v)]
    assert residents and not any(is_quant(v) for v in exp.params.values())
    if family == "sam":
        assert not any("positional" in k for k in residents)  # dequantized at load, full precision
    got, want = _forward(res, family), _forward(exp, family)
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    n_res, n_exp = store_nbytes(res.params), store_nbytes(exp.params)
    assert n_res < 0.55 * n_exp, (n_res, n_exp)


@pytest.mark.parametrize("family", RESIDENT_FAMILIES)
def test_resident_family_matches_the_jax_resident_load(family, tmp_path, chip_smoke, monkeypatch):
    """The port's and the JAX package's resident loads of one Q8_0 file
    (VISP_KEEP_QUANT=1 for both), within the family's port-vs-JAX
    tolerance."""
    path = _q8_file(family, tmp_path, chip_smoke)
    monkeypatch.setenv("VISP_KEEP_QUANT", "1")
    model = api.load_model(path, backend_init("cpu"))
    jmodel = japi.load_model(path, jax_backend_init("cpu"))
    assert any(is_quant(v) for v in model.params.values())
    assert {k for k, v in model.params.items() if is_quant(v)} == \
        {k for k, v in jmodel.params.items() if jquant.is_quant(v)}
    if family == "yolov9t":  # the raw forward: NMS over random weights' near-equal scores is no comparison
        x = (np.random.default_rng(5).standard_normal((1, 64, 64, 3)) * 0.5).astype(np.float32)
        out = yolo.yolov9t_forward(Params(model.params), torch.from_numpy(x))
        ref = jyolo.yolov9t_forward(JParams(jmodel.params), x)
        np.testing.assert_allclose(out.boxes.numpy(), np.asarray(ref.boxes), atol=1e-4, rtol=YOLO_RTOL)
        np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), atol=YOLO_ATOL, rtol=YOLO_RTOL)
        return
    px = sample_image()
    m = np.zeros((72, 96, 1), np.uint8)
    m[20:50, 30:70] = 255
    got = _compute(model, family, Image(px, ImageFormat.rgb_u8), Image(m, ImageFormat.alpha_u8))
    want = _compute(jmodel, family, JaxImage(px, JaxImageFormat.rgb_u8), JaxImage(m, JaxImageFormat.alpha_u8))
    assert got.shape == want.shape and np.abs(np.asarray(got, np.float64)).sum() > 0
    assert _rel_rms(got, want) <= 1e-4  # tests/test_torch_api.py REL_RMS


# dequants a forward of the resident test twins: one a weight's use. A helper
# that only reads a weight's placement (parallel/tp.py) must not add any.
RESIDENT_LOOKUPS = {"depthany": 52, "sam": 40, "birefnet": 102}


@pytest.mark.parametrize("family", sorted(RESIDENT_LOOKUPS))
def test_resident_forward_dequantizes_each_weight_once_per_use(family, tmp_path, chip_smoke, monkeypatch):
    """The lookups of one resident forward (a MobileSAM encode for SAM),
    counted on ``QuantResident.dequant``, are the family's fixed count."""
    path = _q8_file(family, tmp_path, chip_smoke)
    dev = backend_init("cpu")
    model = api.load_model(path, dev.with_flags(dev.flags | BuildFlag.keep_quantized))
    calls = []
    dequant = QuantResident.dequant
    monkeypatch.setattr(QuantResident, "dequant", lambda self, *a, **k: calls.append(1) or dequant(self, *a, **k))
    rng = np.random.default_rng(11)
    if family == "sam":
        model.encode_u8(torch.from_numpy(rng.integers(0, 256, (1, 1024, 1024, 3), dtype=np.uint8)))
    else:
        side = {"depthany": 126, "birefnet": 64}[family]
        model._forward_u8(torch.from_numpy(rng.integers(0, 256, (1, side, side, 3), dtype=np.uint8)))
    assert len(calls) == RESIDENT_LOOKUPS[family]
