"""The port's SWIN backbone (vision_tpu_torch/models/swin.py) against the JAX
package's (vision_tpu/models/swin.py) at the sizes of tests/test_birefnet.py
(SWIN_TEST: embed 8, window 3, 2 heads), on the torch twins' weights, in
f32 on the CPU, where every window attention runs the window kernel's plain
version (the bias and the per-window shift mask apart, as the kernel takes
them)."""

import numpy as np
import pytest
import torch

from test_birefnet import SWIN_TEST, TPatchMergingSwin, TSwin, TSwinBlock, TWindowAttention
from vision_tpu.models import swin as jswin
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.models import swin
from vision_tpu_torch.ops.cuda import window_attention as wa
from workbench import input_tensor, make_params, randomize, state_dict_to_params, to_nhwc
from torch_threads import torch_threads  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4  # f32, summation order only
PORT_SWIN_TEST = swin.SwinParams(
    SWIN_TEST.embed_dim, SWIN_TEST.window_size,
    tuple(swin.SwinLayerParams(lp.depth, lp.n_heads, lp.n_features) for lp in SWIN_TEST.layers),
)


def _port(module):
    return Params(params_from_numpy(state_dict_to_params(module.state_dict()), "cpu", torch.float32))


def _match(out, expected, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=atol, rtol=rtol)


@pytest.mark.parametrize("window", [3, 7, 12])
def test_relative_position_index_equals_jax(window):
    assert np.array_equal(swin._relative_position_index(window), jswin._relative_position_index(window))


@pytest.mark.parametrize("w,h,window", [(6, 6, 3), (7, 5, 3), (12, 9, 3), (14, 14, 7), (66, 66, 12), (8, 8, 12)])
def test_attention_mask_equals_jax(w, h, window):
    ours, theirs = swin.compute_attention_mask(w, h, window), jswin.compute_attention_mask(w, h, window)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_device_mask_is_made_once():
    a = swin._device_mask(7, 5, 3, torch.device("cpu"))
    assert a is swin._device_mask(7, 5, 3, torch.device("cpu"))
    assert a.dtype == torch.float32 and np.array_equal(a.numpy(), jswin.compute_attention_mask(7, 5, 3))


def test_relative_position_bias_equals_jax():
    t = randomize(TWindowAttention(8, 3, 2))
    ours = swin.relative_position_bias(_port(t), 3, 2)
    assert ours.shape == (1, 2, 9, 9) and ours.is_contiguous()
    _match(ours, jswin.relative_position_bias(make_params(t), 3, 2), atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("images", [1, 2])
def test_window_attention_matches_jax(masked, images):
    """4 windows of one 6x6 image (or 2 images: the mask's 4 windows taken
    as w % 4, as the JAX package tiles it)."""
    t = randomize(TWindowAttention(8, 3, 2))
    x = input_tensor(4 * images, 9, 8).numpy()
    mask = swin.compute_attention_mask(6, 6, 3) if masked else None
    before = wa.launches
    out = swin.window_attention(_port(t), torch.from_numpy(x), None if mask is None else torch.tensor(mask), 2, 3)
    assert wa.launches == before
    _match(out, jswin.window_attention(make_params(t), x, mask, 2, 3))


@pytest.mark.parametrize("shift", [0, 1])
def test_block_matches_jax(shift):
    """A 7x7 grid padded to 9x9 (three windows of 3 a side)."""
    t = randomize(TSwinBlock(8, 2, 3, shift))
    x = input_tensor(2, 49, 8).numpy()
    jbp = jswin.BlockParams(n_heads=2, window_size=3, w=7, h=7, shift=shift)
    expected = jswin.block(make_params(t), x, jswin.compute_attention_mask(7, 7, 3), jbp)
    bp = swin.BlockParams(n_heads=2, window_size=3, w=7, h=7, shift=shift)
    out = swin.block(_port(t), torch.from_numpy(x), swin._device_mask(7, 7, 3, torch.device("cpu")), bp)
    _match(out, expected)


def test_patch_merging_matches_jax():
    t = randomize(TPatchMergingSwin(8))
    x = input_tensor(2, 24, 8).numpy()  # 6x4
    _match(swin.patch_merging(_port(t), torch.from_numpy(x), 6, 4), jswin.patch_merging(make_params(t), x, 6, 4))


def test_swin_encode_matches_jax():
    t = randomize(TSwin())
    x = to_nhwc(input_tensor(1, 3, 64, 64))
    outs = swin.swin_encode(_port(t), torch.from_numpy(x), PORT_SWIN_TEST)
    expected = jswin.swin_encode(make_params(t), x, SWIN_TEST)
    assert len(outs) == 4
    for out, e in zip(outs, expected):
        _match(out, e, atol=1e-4, rtol=1e-4)  # 8 blocks deep


def test_swin_detect_params(tmp_path):
    from vision_tpu_torch.core.gguf import GGUFFile, GGUFWriter
    from vision_tpu_torch.core.errors import VispError

    for embed, want in ((96, swin.SWIN_T_PARAMS), (192, swin.SWIN_L_PARAMS)):
        path = tmp_path / f"swin{embed}.gguf"
        w = GGUFWriter(path, "birefnet")
        w.add("swin.embed_dim", embed)
        w.write()
        assert swin.swin_detect_params(GGUFFile(path)) == want
    path = tmp_path / "custom.gguf"
    w = GGUFWriter(path, "birefnet")
    w.add("swin.embed_dim", 8)
    w.add("swin.config", "custom")
    w.add("swin.window", 3)
    w.add("swin.depths", [2, 2, 2, 2])
    w.add("swin.num_heads", [2, 2, 2, 2])
    w.add("swin.dims", [8, 16, 32, 64])
    w.write()
    assert swin.swin_detect_params(GGUFFile(path)) == PORT_SWIN_TEST
    path = tmp_path / "bad.gguf"
    w = GGUFWriter(path, "birefnet")
    w.add("swin.embed_dim", 48)
    w.write()
    with pytest.raises(VispError, match="embed dim"):
        swin.swin_detect_params(GGUFFile(path))


def test_window_partition_rejects_unpadded_input():
    with pytest.raises(ValueError, match="not padded"):
        swin.window_partition(torch.zeros(1, 7, 9, 4), 3)
