"""The port's LoRA (vision_tpu_torch/lora.py, the adapters in ops/nn.py
``linear`` and 1x1 ``conv_2d``, api.merge_adapter, load_model(adapter=))
against the JAX package's, on the same numpy inputs: the adapters one seed
draws, the adapter math (f32, 1e-5 absolute: summation order only), merge
and strip, the adapter file byte for byte, QLoRA on an int8-resident base
(whose shape is read from its metadata, never dequantized), and the
deploy-time merge."""

import jax
import numpy as np
import pytest
import torch

from vision_tpu import lora as jlora
from vision_tpu.core import quant as jquant
from vision_tpu.core.params import Params as JParams
from vision_tpu.ops import nn as jnn
from vision_tpu_torch import lora
from vision_tpu_torch.core import quant
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.core.gguf import GGUFFile
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.ops import nn
from torch_threads import torch_threads  # noqa: F401

ATOL = 1e-5  # f32 products of width <= 24: summation order only


def _base(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "enc.fc1.weight": (rng.normal(size=(24, 16)) * 0.2).astype(np.float32),
        "enc.fc1.bias": (rng.normal(size=(24,)) * 0.1).astype(np.float32),
        "enc.fc2.weight": (rng.normal(size=(8, 24)) * 0.2).astype(np.float32),
        "enc.norm.weight": np.ones(16, np.float32),  # 1-D: never adapted
        "enc.conv.weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),  # 3x3: never adapted
        "enc.proj.weight": rng.normal(size=(6, 5, 1, 1)).astype(np.float32),  # 1x1 conv: adapted
        "enc.proj.bias": rng.normal(size=(6,)).astype(np.float32),
        "buf.idx": np.arange(3, dtype=np.int32),
    }


def _np(store: dict) -> dict:
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v for k, v in store.items()}


def _trained(store: dict, seed=1) -> dict:
    """The adapters' B moved off zero (as training would)."""
    rng = np.random.default_rng(seed)
    out = dict(store)
    for k, v in store.items():
        if k.endswith(".lora_b"):
            out[k] = (rng.normal(size=v.shape) * 0.5).astype(np.float32)
    return out


@pytest.mark.parametrize("kw", [dict(rank=4, seed=0), dict(rank=2, alpha=8.0, seed=5), dict(rank=3, targets="fc2")])
def test_add_lora_draws_the_jax_adapters(kw):
    ours, theirs = lora.add_lora(_base(), **kw), jlora.add_lora(_base(), **kw)
    assert sorted(ours) == sorted(theirs)
    assert lora.lora_modules(ours) == jlora.lora_modules(theirs)
    for k in ours:
        if ".lora_" in k:
            assert isinstance(ours[k], torch.Tensor) and ours[k].dtype == torch.float32
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    assert lora.lora_modules(ours) == (["enc.fc2"] if "targets" in kw else ["enc.fc1", "enc.fc2", "enc.proj"])


def test_add_lora_errors_match_jax():
    for kw in (dict(rank=0), dict(targets="nothing"), dict(targets="conv"), dict(targets="norm")):
        with pytest.raises(VispError):
            lora.add_lora(_base(), **kw)
        with pytest.raises(Exception):
            jlora.add_lora(_base(), **kw)
    with pytest.raises(VispError, match="root param dict"):
        lora.add_lora(Params(_base())["enc"])


def test_linear_and_conv1x1_apply_adapters_as_jax():
    store = _trained(_np(lora.add_lora(_base(), rank=3, seed=2)))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    xc = rng.normal(size=(2, 7, 6, 5)).astype(np.float32)
    port = {k: torch.from_numpy(np.array(v)) for k, v in store.items()}
    np.testing.assert_allclose(nn.linear(Params(port)["enc"]["fc1"], torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.linear(JParams(store)["enc"]["fc1"], x)), atol=ATOL)
    for stride, pad in ((1, 0), (2, 1)):
        np.testing.assert_allclose(
            nn.conv_2d(Params(port)["enc"]["proj"], torch.from_numpy(xc), stride, pad).numpy(),
            np.asarray(jnn.conv_2d(JParams(store)["enc"]["proj"], xc, stride, pad)), atol=ATOL)
    # without adapters the ops are the plain ones, bit for bit
    plain = {k: torch.from_numpy(v) for k, v in _base().items()}
    adapted = lora.add_lora(plain, rank=2)  # B = 0: the adapter adds exact zeros
    assert torch.equal(nn.linear(Params(adapted)["enc"]["fc2"], torch.ones(1, 24)),
                       nn.linear(Params(plain)["enc"]["fc2"], torch.ones(1, 24)))


def test_merge_and_strip_match_jax():
    store = _trained(_np(lora.add_lora(_base(), rank=4, seed=4)))
    port = {k: torch.from_numpy(np.array(v)) for k, v in store.items()}
    merged, jmerged = lora.merge_lora(port), jlora.merge_lora(store)
    assert sorted(merged) == sorted(jmerged) and not lora.lora_modules(merged)
    for k in merged:
        np.testing.assert_allclose(np.asarray(merged[k]), np.asarray(jmerged[k]), atol=ATOL)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 16)).astype(np.float32))
    np.testing.assert_allclose(nn.linear(Params(merged)["enc"]["fc1"], x).numpy(),
                               nn.linear(Params(port)["enc"]["fc1"], x).numpy(), atol=ATOL)
    assert sorted(lora.strip_lora(port)) == sorted(jlora.strip_lora(store)) == sorted(_base())
    bf = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in port.items()}
    assert lora.merge_lora(bf)["enc.fc1.weight"].dtype == torch.bfloat16


def test_adapter_file_equals_jax_byte_for_byte_and_roundtrips(tmp_path):
    store = _trained(_np(lora.add_lora(_base(), rank=2, seed=6)))
    port = {k: torch.from_numpy(np.array(v)) for k, v in store.items()}
    lora.save_lora(port, tmp_path / "a.gguf", arch="demo")
    jlora.save_lora(store, tmp_path / "j.gguf", arch="demo")
    assert (tmp_path / "a.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
    back = lora.load_lora(_base(), tmp_path / "a.gguf")
    jback = jlora.load_lora(_base(), str(tmp_path / "j.gguf"))
    assert sorted(back) == sorted(jback)
    for k in back:
        if ".lora_" in k:
            np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
    assert GGUFFile(str(tmp_path / "a.gguf")).metadata["adapter.type"] == "lora"


def test_adapter_file_validation(tmp_path):
    store = lora.add_lora(_base(), rank=2)
    lora.save_lora(store, tmp_path / "a.gguf")
    with pytest.raises(VispError, match="no base weight"):
        lora.load_lora({"x.weight": np.zeros((2, 2), np.float32)}, tmp_path / "a.gguf")
    wrong = dict(_base())
    wrong["enc.fc1.weight"] = np.zeros((24, 17), np.float32)
    with pytest.raises(VispError, match="does not match"):
        lora.load_lora(wrong, tmp_path / "a.gguf")
    from vision_tpu_torch.core.gguf import GGUFWriter

    w = GGUFWriter(tmp_path / "m.gguf", "demo")
    w.add_tensor("enc.fc1.weight", np.zeros((24, 16), np.float32))
    w.write()
    with pytest.raises(VispError, match="not a LoRA adapter file"):
        lora.load_lora(_base(), tmp_path / "m.gguf")
    with pytest.raises(VispError, match="no LoRA adapters"):
        lora.save_lora(_base(), tmp_path / "none.gguf")


def _resident_base(seed=7):
    rng = np.random.default_rng(seed)
    return {"blk.fc.weight": (rng.normal(size=(64, 128)) * 0.1).astype(np.float32),
            "blk.fc.bias": np.zeros(64, np.float32),
            "blk.pw.weight": (rng.normal(size=(64, 64, 1, 1)) * 0.1).astype(np.float32)}


def test_qlora_adapters_on_resident_base_read_its_metadata(monkeypatch, tmp_path):
    """QLoRA: quantize_store, then add_lora on the int8-resident base draws
    the JAX package's adapters and leaves the base resident; load_lora
    checks shapes from the resident's metadata: no dequant happens (the
    JAX package's load_lora densifies here, a fault not copied)."""
    ours = quant.quantize_store(_resident_base(), dtype=torch.float32, min_elements=1024)
    theirs = jquant.quantize_store(_resident_base(), dtype="float32", min_elements=1024)
    assert all(quant.is_quant(ours[k]) for k in ("blk.fc.weight", "blk.pw.weight"))

    def no_dequant(self):
        raise AssertionError("a resident base was dequantized")

    monkeypatch.setattr(quant.QuantResident, "dequant", no_dequant)
    adapted = lora.add_lora(ours, rank=4, seed=1)
    jadapted = jlora.add_lora(theirs, rank=4, seed=1)
    assert quant.is_quant(adapted["blk.fc.weight"]) and lora.lora_modules(adapted) == ["blk.fc", "blk.pw"]
    for k in jadapted:
        if ".lora_" in k:
            np.testing.assert_array_equal(adapted[k].numpy(), np.asarray(jadapted[k]))
    lora.save_lora(adapted, tmp_path / "q.gguf")
    back = lora.load_lora(ours, tmp_path / "q.gguf")
    assert quant.is_quant(back["blk.fc.weight"]) and lora.lora_modules(back) == ["blk.fc", "blk.pw"]
    monkeypatch.undo()
    # merging densifies: W_dequant + B @ A, as the JAX package's merge
    trained = _trained(back)
    trained = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in trained.items()}
    jtrained = {k: (np.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v) for k, v in trained.items()}
    jtrained.update({k: theirs[k] for k in ("blk.fc.weight", "blk.pw.weight")})
    merged, jmerged = lora.merge_lora(trained), jlora.merge_lora(jtrained)
    for k in ("blk.fc.weight", "blk.pw.weight"):
        np.testing.assert_allclose(merged[k].numpy(), np.asarray(jmerged[k]), atol=ATOL)


def test_qlora_training_moves_only_the_adapters():
    """A train step over LORA_TRAINABLE on a resident base: the adapters
    move (B first), the resident's levels and scales stay bit-unchanged."""
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.train import adam, create_train_state, make_train_step

    store = lora.add_lora(quant.quantize_store(_resident_base(), dtype=torch.float32, min_elements=1024), rank=2)
    store = params_from_numpy(store, "cpu", torch.float32)
    q0 = store["blk.fc.weight"].q.clone()
    state = create_train_state(store, adam(1e-2), trainable=lora.LORA_TRAINABLE)
    assert set(state.names) == {"blk.fc.lora_a", "blk.fc.lora_b", "blk.pw.lora_a", "blk.pw.lora_b"}
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 128)).astype(np.float32))

    def loss_fn(params, batch):
        return torch.mean(nn.linear(Params(params)["blk"]["fc"], batch) ** 2)

    b0 = state.params["blk.fc.lora_b"].detach().clone()
    state, _ = make_train_step(loss_fn)(state, x)
    assert not torch.equal(state.params["blk.fc.lora_b"], b0)
    assert torch.equal(state.params["blk.fc.weight"].q, q0) and quant.is_quant(state.params["blk.fc.weight"])


def test_merge_adapter_and_load_model_adapter_match_jax(tmp_path):
    """api.merge_adapter (the --adapter flag) on a small Depth-Anything GGUF:
    the merged file's KVs equal the JAX package's merge_adapter's and its
    tensors agree within ATOL; load_model(adapter=) serves the merge, which
    differs from the base."""
    from test_torch_api import sample_image, write_family_gguf
    from vision_tpu import api as japi
    from vision_tpu_torch import api
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.weights import load_weights
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.models.depth_anything import fixup_weights

    base = write_family_gguf("depthany", tmp_path)
    f = GGUFFile(base)
    attached = _trained(_np(lora.add_lora(fixup_weights(f, load_weights(f, as_numpy=True)), rank=2, seed=3)))
    lora.save_lora(attached, tmp_path / "ad.gguf", arch=f.arch)
    ours = api.merge_adapter(base, str(tmp_path / "ad.gguf"), dst=str(tmp_path / "m.gguf"))
    theirs = japi.merge_adapter(base, str(tmp_path / "ad.gguf"), dst=str(tmp_path / "jm.gguf"))
    a, b = GGUFFile(ours), GGUFFile(theirs)
    assert a.metadata == b.metadata and list(a.tensors) == list(b.tensors)
    for name in a.tensors:
        np.testing.assert_allclose(a.tensor(name), b.tensor(name), atol=ATOL)
    dev = backend_init("cpu")
    img = Image(sample_image(42, 56), ImageFormat.rgb_u8)
    out_m = api.load_model(ours, dev).compute(img).data
    out_a = api.load_model(base, dev, adapter=str(tmp_path / "ad.gguf")).compute(img).data
    out_b = api.load_model(base, dev).compute(img).data
    np.testing.assert_array_equal(out_a, out_m)
    assert np.abs(out_m - out_b).max() > 1e-4


def test_jax_is_not_needed_for_the_adapters():
    # the port's adapters are torch tensors; the JAX package's numpy arrays
    out = lora.add_lora(_base(), rank=2)
    assert all(isinstance(out[k], torch.Tensor) for k in out if ".lora_" in k)
    assert not any(isinstance(v, jax.Array) for v in out.values())
