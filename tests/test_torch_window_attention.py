"""The port's windowed attention (vision_tpu_torch/ops/cuda/window_attention.py)
against the TPU kernel it replaces, the Pallas ``_kernel`` of
scripts/exp_winattn2.py, run in interpret mode on the CPU; and the port's
``attention_windows`` against the JAX package's.

The script's module body runs its TPU benchmark, so it is not imported: its
text up to the benchmark (``key = jax.random.PRNGKey(0)``) is executed with
``__file__`` set. On the CPU the wrapper runs its plain PyTorch version,
which these tests hold against the Pallas kernel; the CUDA kernel itself is
checked against the same plain version on the card by chip_smoke.py."""

from pathlib import Path

import numpy as np
import pytest
import torch

from vision_tpu.core.params import Params as JParams
from vision_tpu.ops import nn as jnn
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.ops import nn
from vision_tpu_torch.ops.cuda import window_attention as wa
from torch_threads import torch_threads  # noqa: F401

PROBE = Path(__file__).resolve().parents[1] / "scripts" / "exp_winattn2.py"
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def pallas_window_attention():
    text = PROBE.read_text().split("\nkey = jax.random.PRNGKey(0)")[0]
    ns = {"__file__": str(PROBE), "__name__": "exp_winattn2_kernel"}
    exec(compile(text, str(PROBE), "exec"), ns)
    return ns["window_attention"]


def _inputs(seed, nw, t, h, hd):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((nw, t, h * hd)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((h, t, t)).astype(np.float32)
    return q, k, v, bias


def _pallas(fn, q, k, v, bias, h, scale):
    # the Pallas wrapper always takes a bias; "no bias" is a zero one
    b = bias if bias is not None else np.zeros((h, q.shape[1], q.shape[1]), np.float32)
    return np.asarray(fn(q, k, v, b, h, float(scale), interpret=True))


@pytest.mark.parametrize(
    "nw,t,h,hd,with_bias",
    [
        (3, 49, 2, 8, True),  # T ragged against the probe's 8-row tile
        (11, 20, 5, 8, True),  # NW not a multiple of the probe's g = 8
        (5, 20, 2, 16, False),
        (8, 49, 5, 8, False),
        (1, 16, 2, 32, True),  # a single window, T on the tile
    ],
)
def test_plain_matches_pallas_kernel(pallas_window_attention, nw, t, h, hd, with_bias):
    q, k, v, bias = _inputs(nw * 100 + t, nw, t, h, hd)
    bias = bias if with_bias else None
    scale = hd**-0.5
    expected = _pallas(pallas_window_attention, q, k, v, bias, h, scale)
    out = wa.window_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), None if bias is None else torch.from_numpy(bias), h, scale
    )
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), expected, atol=ATOL, rtol=RTOL)


def test_plain_matches_pallas_kernel_bf16(pallas_window_attention):
    """The Pallas body's roundings at bf16: q * scale rounded to bf16, p
    rounded to v's type, output in q's type (one bf16 ulp apart at most)."""
    import jax.numpy as jnp

    q, k, v, bias = _inputs(7, 4, 49, 2, 16)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    expected = np.asarray(
        pallas_window_attention(*jb, jnp.asarray(bias, jnp.bfloat16), 2, 0.25, interpret=True).astype(jnp.float32)
    )
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = wa.window_attention(*tb, torch.from_numpy(bias).to(torch.bfloat16), 2, 0.25)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), expected, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("split_dim", [1, 2])
@pytest.mark.parametrize("with_mask", [True, False])
def test_attention_windows_matches_jax(split_dim, with_mask):
    rng = np.random.default_rng(split_dim)
    b, t, c, h = 6, 49, 20, 4
    store = {
        "qkv.weight": (rng.standard_normal((3 * c, c)) * 0.3).astype(np.float32),
        "qkv.bias": rng.standard_normal(3 * c).astype(np.float32),
        "proj.weight": (rng.standard_normal((c, c)) * 0.3).astype(np.float32),
        "proj.bias": rng.standard_normal(c).astype(np.float32),
    }
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = rng.standard_normal((1, h, t, t)).astype(np.float32) if with_mask else None
    p = Params(params_from_numpy(store, "cpu", torch.float32))
    out = nn.attention_windows(p, torch.from_numpy(x), h, split_dim, None if mask is None else torch.from_numpy(mask), 0.3)
    expected = jnn.attention_windows(JParams(store), x, h, split_dim, mask, 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=1e-4, rtol=1e-3)


def test_split_qkv_rejects_unknown_layout():
    p = Params({"qkv.weight": torch.zeros(24, 8), "qkv.bias": torch.zeros(24)})
    with pytest.raises(ValueError, match="split_dim"):
        nn.attention_windows(p, torch.zeros(1, 4, 8), 2, 3, None, 1.0)


def test_plain_takes_any_broadcastable_mask_on_cpu():
    q, k, v, _ = _inputs(3, 4, 9, 2, 4)
    per_window = np.random.default_rng(4).standard_normal((4, 2, 9, 9)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = wa.window_attention(tq, tk, tv, torch.from_numpy(per_window), 2, 0.5)
    for w in range(4):
        one = wa.window_attention(tq[w : w + 1], tk[w : w + 1], tv[w : w + 1], torch.from_numpy(per_window[w]), 2, 0.5)
        np.testing.assert_allclose(out[w : w + 1].numpy(), one.numpy(), atol=1e-6)


def test_cpu_call_counts_no_launch():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(5, 2, 9, 2, 4))
    before = wa.launches
    wa.window_attention(q, k, v, bias, 2, 0.5)
    assert wa.launches == before


def test_non_cpu_tensors_never_fall_back():
    """Only CPU tensors take the plain version; anything else reaches the
    kernel's checks, which raise on what the kernel does not take."""
    q = torch.zeros(2, 49, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        wa.window_attention(q, q, q, None, 2, 0.5)
    with pytest.raises(ValueError, match="CUDA device"):
        wa.window_attention(torch.zeros(2, 49, 64), q, q, torch.zeros(1, 2, 49, 49, device="meta"), 2, 0.5)


def test_per_window_mask_off_the_cpu_names_the_slice():
    """Off the CPU the kernel takes a per-window mask only as window_mask,
    (nW, T, T) float32 with NW a multiple of nW: a per-window bias, or a
    window_mask of any other shape or type, raises before any launch."""
    q = torch.zeros(4, 49, 64, device="meta")
    with pytest.raises(ValueError, match=r"window_mask, \(nW, T, T\)"):
        wa.window_attention(q, q, q, torch.zeros(4, 2, 49, 49, device="meta"), 2, 0.5)
    for bad in [(4, 2, 49, 49), (3, 49, 49), (8, 49, 49), (2, 49, 48), (49, 49)]:
        with pytest.raises(ValueError, match=r"window_mask must be \(nW, T, T\)"):
            wa.window_attention(q, q, q, None, 2, 0.5, torch.zeros(bad, device="meta"))
    with pytest.raises(ValueError, match="window_mask dtype"):
        wa.window_attention(q, q, q, None, 2, 0.5, torch.zeros(2, 49, 49, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        wa.window_attention(q, q, q, None, 2, 0.5, torch.zeros(2, 49, 49, device="meta"))


def _shift_like_mask(rng, n_masks, t):
    """0 / -inf per window, never a whole row (each query keeps itself)."""
    m = np.where(rng.random((n_masks, t, t)) < 0.3, -np.inf, 0.0).astype(np.float32)
    m[:, np.arange(t), np.arange(t)] = 0.0
    return m


@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_window_mask_equals_the_bias_it_adds(with_bias):
    """window_mask[w % nW] is added to window w's logits with the bias: the
    same as the per-window bias bias + mask tiled over the batch's images."""
    rng = np.random.default_rng(9)
    q, k, v, bias = _inputs(8, 6, 16, 2, 8)
    mask = _shift_like_mask(rng, 3, 16)
    b = bias if with_bias else np.zeros_like(bias)
    combined = b[None] + np.tile(mask, (2, 1, 1))[:, None]  # (6, H, T, T)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = wa.window_attention(tq, tk, tv, torch.from_numpy(bias) if with_bias else None, 2, 0.4,
                              torch.from_numpy(mask))
    expected = wa.window_attention(tq, tk, tv, torch.from_numpy(combined), 2, 0.4)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), expected.numpy(), atol=1e-6)


def test_attention_windows_with_window_mask_matches_jax():
    """The port passes the bias and the per-window mask apart; the JAX
    package takes their sum, tiled over the images (vision_tpu/models/swin.py
    window_attention)."""
    rng = np.random.default_rng(10)
    b, t, c, h, n_masks = 8, 9, 16, 2, 4
    store = {
        "qkv.weight": (rng.standard_normal((3 * c, c)) * 0.3).astype(np.float32),
        "qkv.bias": rng.standard_normal(3 * c).astype(np.float32),
        "proj.weight": (rng.standard_normal((c, c)) * 0.3).astype(np.float32),
        "proj.bias": rng.standard_normal(c).astype(np.float32),
    }
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    bias = rng.standard_normal((1, h, t, t)).astype(np.float32)
    mask = _shift_like_mask(rng, n_masks, t)
    p = Params(params_from_numpy(store, "cpu", torch.float32))
    out = nn.attention_windows(p, torch.from_numpy(x), h, 2, torch.from_numpy(bias), 0.3,
                               window_mask=torch.from_numpy(mask))
    combined = np.tile(mask[:, None], (b // n_masks, 1, 1, 1)) + bias
    expected = jnn.attention_windows(JParams(store), x, h, 2, combined, 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=1e-4, rtol=1e-3)


# TinyViT's stages in a SamServer batch of 6 1024x1024 images, and SWIN-L's
# at 1024x1024 in a BiRefNet batch of 4: (label, NW, T, H, nW masks)
def _served_stages():
    from vision_tpu_torch.models.swin import compute_attention_mask

    stages = [(f"TinyViT stage {i + 1}", 6 * nw, t, h, 0)
              for i, (nw, t, h) in enumerate(((361, 49, 4), (25, 196, 5), (100, 49, 10)))]
    for i, (side, h) in enumerate(((256, 6), (128, 12), (64, 24), (32, 48))):
        n_masks = compute_attention_mask(side, side, 12).shape[0]
        stages.append((f"SWIN-L stage {i + 1}", 4 * n_masks, 144, h, n_masks))
    return stages


@pytest.mark.parametrize("stage", range(7))
def test_window_plan_covers_every_problem_once_in_two_waves(stage):
    """The bf16 kernel's launch plan at every served stage: every (window,
    head) problem in exactly one block, each block's windows of one mask
    class, the staged mask and biases within a block's shared memory, and
    at least two waves of the card's SMs."""
    label, nw, t, h, n_masks = _served_stages()[stage]
    plan = wa.window_plan(nw, t, h, n_masks, 2)
    blocks = list(plan.problems(nw, h))
    assert len(blocks) == plan.blocks
    seen = [p for block in blocks for p in block]
    assert sorted(seen) == [(w, hh) for w in range(nw) for hh in range(h)], label
    if n_masks:
        assert all(len({w % n_masks for w, _ in block}) == 1 for block in blocks), label
    assert all(len(block) <= plan.heads * plan.run for block in blocks)
    assert plan.staged and plan.smem <= wa.SMEM_MAX and plan.threads == 32 * -(-t // 16)
    assert plan.waves >= 2, (label, plan)


def test_window_plan_reads_from_l2_where_staging_does_not_fit():
    """T 256 with an f32 mask and an f32 bias: 512 KB of staging does not fit
    a block, so both come from L2 and shared memory holds only q, k and v."""
    plan = wa.window_plan(8, 256, 2, 4, 4)
    assert not plan.staged and plan.smem == 2 * 3 * 256 * 64
    assert sorted(p for b in plan.problems(8, 2) for p in b) == [(w, h) for w in range(8) for h in range(2)]
    assert wa.window_plan(8, 256, 2, 0, 0).staged  # nothing to stage
