"""The ``vtt`` operators (vision_tpu_torch/ops/cuda/library.py) on the CPU:
``torch.library.opcheck`` of each (schema, fake implementation, autograd
registration, AOT dispatch), each output bit-equal to its kernel's plain
version, each ``_out`` form writing only its channel view, and each flop
formula equal to ``FlopCounterMode``'s count of the plain version's
products. The CUDA implementations run on the card (chip_smoke.py phase
39)."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vision_tpu_torch.ops.cuda import conv3x3 as cc
from vision_tpu_torch.ops.cuda import deform_conv as dc
from vision_tpu_torch.ops.cuda import deform_sample as ds
from vision_tpu_torch.ops.cuda import dequant as dq
from vision_tpu_torch.ops.cuda import flash_attention as fa
from vision_tpu_torch.ops.cuda import library
from vision_tpu_torch.ops.cuda import window_attention as wa
from torch_threads import torch_threads  # noqa: F401

vtt = torch.ops.vtt


def _t(seed, *shape, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


def _samples():
    """op name -> [(args, the plain version's output)] at small shapes."""
    q, k, v = _t(0, 2, 2, 16, 32), _t(1, 2, 2, 24, 32), _t(2, 2, 2, 24, 32)
    wq, wk, wv = _t(3, 4, 16, 64), _t(4, 4, 16, 64), _t(5, 4, 16, 64)
    bias, wmask = _t(6, 2, 16, 16), _t(7, 2, 16, 16)
    x, w, b = _t(8, 2, 5, 6, 8), _t(9, 4, 8, 3, 3), _t(10, 4)
    r = _t(11, 2, 5, 6, 4)
    scale, shift = _t(12, 4), _t(13, 4)
    dx, dw, off, msk = _t(14, 1, 6, 7, 8), _t(15, 5, 8, 3, 3), _t(16, 1, 6, 7, 18) * 2, torch.sigmoid(_t(17, 1, 6, 7, 9))
    qi = torch.from_numpy(np.random.default_rng(18).integers(-127, 128, 4 * 3 * 8, dtype=np.int8))
    qs, qm = _t(19, 3).abs(), _t(20, 3)
    conv_kw = dict(b=b, scale=scale, shift=shift, silu=True, slope=None, r1=r, s1=0.5, r2=None, s2=1.0)
    return {
        "flash_attention": [((q, k, v, 0.2), fa.flash_attention_plain(q, k, v, 0.2)),
                            ((q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.2),
                             fa.flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.2))],
        "window_attention": [((wq, wk, wv, bias, 2, 0.3, wmask),
                              wa.window_attention_plain(wq, wk, wv, bias, 2, 0.3, wmask)),
                             ((wq, wk, wv, None, 2, 0.3, None), wa.window_attention_plain(wq, wk, wv, None, 2, 0.3))],
        "conv3x3": [((x, w, b, scale, shift, True, None, r, 0.5, None, 1.0), cc.conv3x3_plain(x, w, **conv_kw)),
                    ((x, w, None, None, None, False, 0.2, None, 1.0, r, 2.0),
                     cc.conv3x3_plain(x, w, slope=0.2, r2=r, s2=2.0))],
        "deform_conv": [((dx, dw, off, msk, 3, 3, 1, 1, None, _t(21, 5), None, None, True, None),
                         dc.deform_conv_plain(dx, dw, off, msk, 3, 3, 1, 1, bias=_t(21, 5), relu=True)),
                        ((dx, dw, off, None, 3, 3, 1, 1, 2.0, None, _t(22, 5), _t(23, 5), False, None),
                         dc.deform_conv_plain(dx, dw, off, None, 3, 3, 1, 1, 2.0, scale=_t(22, 5), shift=_t(23, 5)))],
        "deform_sample": [((dx, off, msk, 3, 3, 1, 1, None), ds.deform_sample_plain(dx, off, msk, 3, 3, 1, 1)),
                          ((dx, off, None, 3, 3, 1, 1, 2.0), ds.deform_sample_plain(dx, off, None, 3, 3, 1, 1, 2.0))],
        "dequant": [((qi, qs, None, [4, 3, 8], [2, 0, 1], torch.float32),
                     dq.dequant_plain(qi, qs, None, (4, 3, 8), (2, 0, 1), torch.float32)),
                    ((qi, qs, qm, [12, 8], None, torch.bfloat16),
                     dq.dequant_plain(qi, qs, qm, (12, 8), None, torch.bfloat16))],
    }


SAMPLES = _samples()
CASES = [(name, i) for name, cases in SAMPLES.items() for i in range(len(cases))]


def _out_cases():
    """(op, args without out, width of the buffer, channel offset, plain output)."""
    x, w, r = _t(30, 2, 5, 6, 8), _t(31, 4, 8, 3, 3), _t(32, 2, 5, 6, 4)
    dx, dw, off = _t(33, 1, 6, 7, 8), _t(34, 5, 8, 3, 3), _t(35, 1, 6, 7, 18)
    return [
        ("conv3x3_out", (x, w, None, None, None, False, 0.2, r, 1.0, None, 1.0), 10, 3,
         cc.conv3x3_plain(x, w, slope=0.2, r1=r)),
        ("deform_conv_out", (dx, dw, off, None, 3, 3, 1, 1, None, None, None, None, True, None), 12, 4,
         dc.deform_conv_plain(dx, dw, off, None, 3, 3, 1, 1, relu=True)),
    ]


def test_every_kernel_entry_point_is_an_op():
    assert set(library.OPS) == {"flash_attention", "window_attention", "conv3x3", "conv3x3_out", "deform_conv",
                                "deform_conv_out", "deform_sample", "dequant"}
    for name in library.OPS:
        assert getattr(vtt, name).default.name() == f"vtt::{name}"


@pytest.mark.parametrize("name,i", CASES)
def test_opcheck_on_cpu(name, i):
    args, _ = SAMPLES[name][i]
    torch.library.opcheck(getattr(vtt, name).default, args)


@pytest.mark.parametrize("name,i", CASES)
def test_op_is_bit_equal_to_the_plain_version(name, i):
    args, want = SAMPLES[name][i]
    got = getattr(vtt, name)(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", range(2))
def test_out_op_writes_only_its_view(case):
    name, args, width, at, want = _out_cases()[case]
    n, h, w_, c = want.shape
    buf = _t(40, n, h, w_, width)
    keep = buf.clone()
    view = buf[..., at:at + c]
    torch.library.opcheck(getattr(vtt, name).default, (*args, buf.clone()[..., at:at + c]))
    assert getattr(vtt, name)(*args, view) is None
    assert torch.equal(view, want)
    assert torch.equal(buf[..., :at], keep[..., :at]) and torch.equal(buf[..., at + c:], keep[..., at + c:])


def _flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as mode:
        fn(*args)
    return mode.get_total_flops()


def _plain(name):
    """op name -> a function of the op's arguments running the plain version."""
    return {
        "flash_attention": fa.flash_attention_plain,
        "window_attention": wa.window_attention_plain,
        "conv3x3": lambda x, w, b, sc, sh, silu, slope, r1, s1, r2, s2: cc.conv3x3_plain(
            x, w, b, scale=sc, shift=sh, silu=silu, slope=slope, r1=r1, s1=s1, r2=r2, s2=s2),
        "deform_conv": lambda x, w, o, m, kh, kw, st, pad, bd, b, sc, sh, relu, lay: dc.deform_conv_plain(
            x, w, o, m, kh, kw, st, pad, bd, bias=b, scale=sc, shift=sh, relu=relu),
        "deform_sample": ds.deform_sample_plain,
        "dequant": dq.dequant_plain,
    }[name]


@pytest.mark.parametrize("name,i", CASES)
def test_flop_formula_counts_the_plain_versions_products(name, i):
    args, _ = SAMPLES[name][i]
    want = _flops(_plain(name), *args)
    assert _flops(getattr(vtt, name), *args) == want
    if name in ("deform_sample", "dequant"):
        assert want == 0  # gathers and casts: no product, as the JAX counter counts them
    else:
        assert want > 0


def test_fake_implementations_give_the_output_without_running():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        for name, cases in SAMPLES.items():
            args, want = cases[0]
            fake = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args)
            got = getattr(vtt, name)(*fake)
            assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype, name
