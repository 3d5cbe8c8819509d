"""The FLOP count of each vision-bench row (vision_tpu_torch/benchmark.py):
the port's ``count_flops`` of the row's step (fake tensors) against the JAX
package's ``count_flops`` of its row (vision_tpu/benchmark.py, a trace),
both in f32 on the CPU, over the rows whose random weights hold under ~100 M
parameters (not SAM3's ViT-H, not SWIN-L BiRefNet). The ESRGAN rows are
counted against the JAX package's plain RRDB forward, which the port runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu.benchmark as vb
import vision_tpu_torch.benchmark as tb
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.utils.flops import count_flops as jax_count_flops
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.utils.flops import count_flops

FLOPS_RTOL = 5e-3
SMALL_ROWS = [n for n in tb.BENCHMARKS if n not in ("sam3-vision-1008", "birefnet-full-1024")]


def _jax_plain_esrgan_row(name: str):
    """The JAX ESRGAN row's step over the plain RRDB forward (esrgan_generate)
    on the row's raw weights and input: the JAX row itself times the packed
    block-domain form (esrgan_pack_weights, a TPU layout the port does not
    take), whose tail counts extra products for lane fill
    (vision_tpu/benchmark.py:308-311), so the port's plain form is counted
    against JAX's plain form."""
    from vision_tpu.core.params import Params as JParams
    from vision_tpu.models.esrgan import EsrganParams, esrgan_generate
    from vision_tpu.models.random_weights import random_esrgan_params
    from vision_tpu.ops.preprocess import normalize_u8

    res = int(name.removeprefix("esrgan-"))

    def step(w, x):
        y = esrgan_generate(JParams(w), normalize_u8(x, dtype=jnp.float32), EsrganParams(4, 23))
        return jnp.sum(y.astype(jnp.float32))

    x = jnp.asarray(np.random.default_rng(0).integers(0, 256, (1, res, res, 3), dtype=np.uint8))
    return step, random_esrgan_params(0), x


@pytest.mark.parametrize("name", SMALL_ROWS)
def test_row_flops_match_the_jax_rows(name):
    """count_flops of the port's step (fake tensors) against the JAX
    package's count of its row (a trace), both in f32 on the CPU; the
    ESRGAN rows against the JAX row's step over the plain forward."""
    step, params, x = tb.BENCHMARKS[name](backend_init("cpu"), torch.float32)
    got = count_flops(step, params, x)
    if name.startswith("esrgan"):
        jstep, jparams, jx = _jax_plain_esrgan_row(name)
    else:
        jstep, jparams, jx = vb.BENCHMARKS[name](jax_backend_init("cpu"), jnp.float32)
    want = jax_count_flops(jstep, jparams, jx)
    assert got > 0
    assert got == pytest.approx(want, rel=FLOPS_RTOL)
