"""The port's training subsystem (vision_tpu_torch/train.py) against the JAX
package's (vision_tpu/train.py, optax adam): a step's gradients (f32,
relative RMS 1e-6: the same math, another order) and parameters after it
(within a few x lr: Adam turns a gradient near 0 into an update of about
+-lr, so the sign of rounding noise decides it), with and without gradient
accumulation; trainable / frozen partitioning; the EMA; export_gguf byte for
byte; data_loader's order for a seed; prefetch_to_device; and the
torch.save checkpoints (bit-exact restore, resume equal to an uninterrupted
run)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_tpu import train as jtrain
from vision_tpu_torch import train
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.core.gguf import GGUFFile, GGUFWriter
from vision_tpu_torch.core.quant import quantize_resident

LR = 5e-2
GRAD_REL_RMS = 1e-6
PARAM_ATOL = 3 * LR  # a few x lr: see the module docstring


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "head.w.weight": (rng.normal(size=(4, 8)) * 0.1).astype(np.float32),
        "head.w.bias": np.zeros(4, np.float32),
        "body.fc.weight": (rng.normal(size=(8, 8)) * 0.3).astype(np.float32),
        "buf.count": np.array([1, 2, 3], np.int32),  # non-float buffer
    }
    w_true = rng.normal(size=(4, 8)).astype(np.float32)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    return params, (x, np.tanh(x) @ w_true.T)


def _loss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["body.fc.weight"].T)
    return torch.mean((h @ p["head.w.weight"].T + p["head.w.bias"] - y) ** 2)


def _jloss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["body.fc.weight"].T)
    return jnp.mean((h @ p["head.w.weight"].T + p["head.w.bias"] - y) ** 2)


def _t(batch):
    return tuple(torch.from_numpy(np.array(b)) for b in batch)


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-30))


@pytest.mark.parametrize("trainable", [None, r"^head\."])
def test_step_matches_the_jax_step(trainable):
    """Three steps: the loss each step, the first step's gradients (tight),
    the parameters after each (PARAM_ATOL), frozen and non-float leaves
    unchanged, the step count."""
    params, batch = _problem()
    state = train.create_train_state(params, train.adam(LR), trainable=trainable)
    step = train.make_train_step(_loss, trainable=trainable)
    opt = optax.adam(LR)
    jstate = jtrain.create_train_state(params, opt, trainable=trainable)
    jstep = jtrain.make_train_step(_jloss, opt, trainable=trainable)
    names = [k for k in params if k != "buf.count" and (trainable is None or k.startswith("head."))]
    assert list(state.names) == names
    train_t = [state.params[k] for k in names]
    grads = torch.autograd.grad(_loss(state.params, _t(batch)), train_t)
    jg = jax.grad(lambda t: _jloss({**params, **t}, batch))({k: params[k] for k in names})
    for k, g in zip(names, grads):
        assert rel_rms(g, jg[k]) <= GRAD_REL_RMS, k
    for _ in range(3):
        state, m = step(state, _t(batch))
        jstate, jm = jstep(jstate, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        for k in names:
            np.testing.assert_allclose(state.params[k].detach().numpy(), np.asarray(jstate.params[k]),
                                       atol=PARAM_ATOL)
    assert state.step == 3 == int(jstate.step)
    for k in params:
        if k not in names:
            np.testing.assert_array_equal(state.params[k].numpy(), params[k])
            assert not state.params[k].requires_grad


def test_grad_accum_equals_the_full_batch_and_the_jax_accum_step():
    """accum=4 over four equal microbatches: the mean of the f32-summed
    microbatch gradients is the full-batch gradient, so the parameters after
    the step equal the full-batch step's (to f32 rounding) and the JAX
    package's accumulating step's (PARAM_ATOL)."""
    params, (x, y) = _problem()
    micro = (x.reshape(4, 4, 8), y.reshape(4, 4, 4))
    full, _ = train.make_train_step(_loss)(train.create_train_state(params, train.adam(LR)), _t((x, y)))
    acc, m = train.make_train_step(_loss, accum=4)(train.create_train_state(params, train.adam(LR)), _t(micro))
    opt = optax.adam(LR)
    jacc, jm = jtrain.make_train_step(_jloss, opt, accum=4)(jtrain.create_train_state(params, opt), micro)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    for k in full.names:
        np.testing.assert_allclose(acc.params[k].detach().numpy(), full.params[k].detach().numpy(), rtol=2e-6,
                                   atol=2e-7)
        np.testing.assert_allclose(acc.params[k].detach().numpy(), np.asarray(jacc.params[k]), atol=PARAM_ATOL)


def test_step_validation():
    params, (x, y) = _problem()
    with pytest.raises(VispError, match="accum must be >= 1"):
        train.make_train_step(_loss, accum=0)
    with pytest.raises(VispError, match="leading axis 4"):
        train.make_train_step(_loss, accum=4)(train.create_train_state(params, train.adam(LR)), _t((x, y)))
    with pytest.raises(VispError, match="no trainable parameters"):
        train.create_train_state(params, train.adam(LR), trainable="nothing")
    state = train.create_train_state(params, train.adam(LR), trainable=r"^head\.")
    with pytest.raises(VispError, match="other leaves"):
        train.make_train_step(_loss, trainable=r"^body\.")(state, _t((x, y)))


def test_unreached_leaf_gets_a_zero_gradient_as_in_jax():
    """A trainable leaf the loss does not reach: a zero gradient (Adam moves
    it by nothing), as jax.grad gives it."""
    params, batch = _problem()
    params["spare.weight"] = np.ones((2, 2), np.float32)
    state, _ = train.make_train_step(_loss)(train.create_train_state(params, train.adam(LR)), _t(batch))
    np.testing.assert_array_equal(state.params["spare.weight"].detach().numpy(), params["spare.weight"])


def test_resident_leaves_are_frozen():
    params, batch = _problem()
    params["res.weight"] = quantize_resident(np.ones((4, 32), np.float32), torch.float32)
    state = train.create_train_state(params, train.adam(LR))
    assert "res.weight" not in state.names and state.params["res.weight"] is params["res.weight"]


def test_ema_update_matches_jax():
    params, _ = _problem()
    rng = np.random.default_rng(1)
    ema = {k: (v + rng.normal(size=v.shape).astype(v.dtype)) if v.dtype == np.float32 else v for k, v in params.items()}
    ours = train.ema_update({k: torch.from_numpy(np.array(v)) for k, v in ema.items()},
                            {k: torch.from_numpy(np.array(v)) for k, v in params.items()}, decay=0.9)
    theirs = jtrain.ema_update(ema, params, decay=0.9)
    for k in params:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ours["buf.count"].numpy(), params["buf.count"])


@pytest.mark.parametrize("float_type", ["f32", "f16"])
def test_export_gguf_equals_jax_byte_for_byte(tmp_path, float_type):
    """export_gguf with a source file (its KVs echoed, the layout KVs
    replaced by tensor_data_layout = "torch"), a resident leaf densified,
    torch tensors that require grad: the file is the JAX package's byte for
    byte."""
    params, _ = _problem()
    src = tmp_path / "src.gguf"
    w = GGUFWriter(src, "demo")
    w.add("demo.tensor_data_layout", "cwhn")
    w.add("demo.depth", 3)
    w.add("general.name", "toy")
    w.add_tensor("x", np.zeros(2, np.float32))
    w.write()
    res = quantize_resident(np.linspace(-1, 1, 64, dtype=np.float32).reshape(2, 32), torch.float32)
    ours = {k: torch.from_numpy(np.array(v)).requires_grad_(v.dtype == np.float32) for k, v in params.items()}
    train.export_gguf(ours | {"res.weight": res}, tmp_path / "a.gguf", source=src, float_type=float_type)
    from vision_tpu.core.quant import quantize_resident as jquantize_resident

    jres = jquantize_resident(np.linspace(-1, 1, 64, dtype=np.float32).reshape(2, 32), "float32")
    jtrain.export_gguf(params | {"res.weight": jres}, tmp_path / "j.gguf", source=str(src), float_type=float_type)
    assert (tmp_path / "a.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
    f = GGUFFile(str(tmp_path / "a.gguf"))
    assert f.metadata["demo.tensor_data_layout"] == "torch" and f.metadata["demo.depth"] == 3
    with pytest.raises(VispError, match="float_type"):
        train.export_gguf(ours, tmp_path / "b.gguf", arch="demo", float_type="q8_0")
    with pytest.raises(VispError, match="arch"):
        train.export_gguf(ours, tmp_path / "b.gguf")


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=3), dict(shuffle=False), dict(shuffle=True, seed=9,
                                                                                       drop_last=False)])
def test_data_loader_order_matches_jax(kw):
    items = [(i, np.full((2,), i, np.float32)) for i in range(11)]
    load = lambda it: (np.float32(it[0]), it[1] * 2)  # noqa: E731
    ours = list(train.data_loader(items, 3, load=load, workers=3, **kw))
    theirs = list(jtrain.data_loader(items, 3, load=load, workers=3, **kw))
    assert len(ours) == len(theirs) == (4 if kw.get("drop_last") is False else 3)
    for a, b in zip(ours, theirs):
        assert isinstance(a, tuple)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))
    with pytest.raises(VispError, match="batch_size"):
        list(train.data_loader(items, 0))
    assert list(train.data_loader([], 2)) == []


def test_prefetch_to_device_keeps_order_and_makes_tensors():
    batches = [(np.full((2, 3), i, np.float32), {"m": np.arange(i, i + 2)}) for i in range(5)]
    out = list(train.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, (x, d) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu" and float(x[0, 0]) == i
        assert torch.equal(d["m"], torch.arange(i, i + 2))
    with pytest.raises(VispError, match="size"):
        list(train.prefetch_to_device(iter(batches), size=0))


def _state_equal(a: train.TrainState, b: train.TrainState) -> None:
    assert a.step == b.step and a.names == b.names
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for key, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][key])), (i, key)


def test_checkpoint_restores_bit_exact_and_resumes_as_an_unbroken_run(tmp_path):
    """(state, ema) saved after 2 steps and restored into a fresh state:
    every tensor, the optimizer's moments and counts, the step and the EMA
    bit-equal; two more steps from the restore equal two more steps of the
    run that never stopped. The write is atomic (no temporary directory
    left) and latest_checkpoint finds the newest step_*."""
    params, batch = _problem()
    step = train.make_train_step(_loss)
    run = train.create_train_state(params, train.adam(LR))
    ema = {k: v.detach().clone() for k, v in run.params.items()}
    for _ in range(2):
        run, _ = step(run, _t(batch))
        ema = train.ema_update(ema, run.params, decay=0.5)
    train.save_checkpoint(tmp_path / "step_1", run)
    path = train.save_checkpoint(tmp_path / "step_2", (run, ema))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1", "step_2"]
    assert train.latest_checkpoint(tmp_path) == path and train.latest_checkpoint(tmp_path / "none") is None
    fresh = train.create_train_state(params, train.adam(LR))
    fresh_ema = {k: v.detach().clone() for k, v in fresh.params.items()}
    back, back_ema = train.restore_checkpoint(path, (fresh, fresh_ema))
    assert back is fresh
    _state_equal(back, run)
    for k in ema:
        assert torch.equal(back_ema[k], ema[k])
    for _ in range(2):
        run, _ = step(run, _t(batch))
        back, _ = step(back, _t(batch))
    _state_equal(back, run)
    with pytest.raises(VispError, match="exists"):
        train.save_checkpoint(path, run, force=False)
    other = train.create_train_state(params, train.adam(LR), trainable=r"^head\.")
    with pytest.raises(VispError, match="other leaves"):
        train.restore_checkpoint(path, other)
