"""The port's flash attention (vision_tpu_torch/ops/cuda/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the wrapper runs its plain PyTorch version, which these tests
hold against the Pallas kernel; the CUDA kernel itself is checked against
the same plain version on the card by chip_smoke.py (phase 3)."""

import numpy as np
import pytest
import torch

from vision_tpu.ops.nn import attention_route as jax_attention_route
from vision_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from vision_tpu_torch.ops.cuda import flash_attention as fa
from vision_tpu_torch.ops.nn import CUDA_MIN_T, FUSED_LOGIT_MAX_T, attention_route


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, tq, d)).astype(np.float32),
        rng.standard_normal((b, h, tk, d)).astype(np.float32),
        rng.standard_normal((b, h, tk, d)).astype(np.float32),
    )


@pytest.mark.parametrize("t,d,block_q", [(256, 64, 128), (300, 32, 128), (64, 64, 256)])
def test_flash_attention_matches_pallas(t, d, block_q):
    q, k, v = _qkv(0, 2, 3, t, t, d)
    scale = d**-0.5
    expected = jax_flash_attention(q, k, v, scale=scale, block_q=block_q, interpret=True)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=2e-5, rtol=1e-4)


def test_flash_attention_cross():
    """Tq != Tk (decoder-style cross attention)."""
    q, k, v = _qkv(1, 1, 2, 7, 150, 32)
    expected = jax_flash_attention(q, k, v, block_q=128, interpret=True)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert out.shape == (1, 2, 7, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=2e-5, rtol=1e-4)


def test_flash_attention_rejects_mask():
    q = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention(q, q, q, mask=torch.zeros(8, 8))


def test_flash_attention_bf16_dtype():
    """bf16 in, bf16 out, f32 statistics — against the Pallas kernel on the
    same bf16 inputs."""
    import jax.numpy as jnp

    q, _, _ = _qkv(2, 1, 2, 128, 128, 32)
    qb = jnp.asarray(q, jnp.bfloat16)
    expected = np.asarray(jax_flash_attention(qb, qb, qb, block_q=128, interpret=True), np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    out = fa.flash_attention(qt, qt, qt)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), expected, atol=5e-2)


def test_flash_attention_cpu_call_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 40, 40, 32))
    before = fa.launches
    fa.flash_attention(q, k, v)
    assert fa.launches == before


@pytest.mark.parametrize(
    "t_q,has_mask,flash,ok",
    [
        (5184, False, False, None),
        (49, True, False, None),
        (CUDA_MIN_T, False, True, True),
        (CUDA_MIN_T, False, True, False),
        (49, True, True, None),
        (FUSED_LOGIT_MAX_T, True, True, None),
        (FUSED_LOGIT_MAX_T + 1, True, True, None),
        (256, False, True, True),
        (CUDA_MIN_T - 1, False, True, True),
    ],
)
def test_attention_route_matches_jax(t_q, has_mask, flash, ok):
    """The routing table, case by case, against the JAX package's, with its
    "pallas" route as the port's "cuda" route."""
    want = jax_attention_route(t_q, has_mask, flash, pallas_ok=ok)
    got = attention_route(t_q, has_mask, flash, cuda_ok=ok)
    assert got == {"pallas": "cuda"}.get(want, want)


def test_flash_attention_non_cpu_tensors_never_fall_back():
    """Only CPU tensors take the plain version; anything else must reach the
    kernel's checks, which raise on what the kernel does not take."""
    q = torch.zeros(1, 1, 8, 32)
    k = torch.zeros(1, 1, 8, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, k, k)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from vision_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
