"""Analytic matrix-product and convolution FLOP counting — the port of
vision_tpu/utils/flops.py.

``count_flops(fn, *args)`` runs ``fn`` once under
``torch.utils.flop_counter.FlopCounterMode`` and sums 2 x multiply-adds over
every matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and
convolution, and over every ``vtt`` operator (ops/cuda/library.py: the
attention kernels' two products, the 3x3 and deformable convs; 0 for the
sampler and the dequant): the count the JAX counter takes from
``dot_general`` and ``conv_general_dilated``. A matrix-vector product
(``mv``, ``dot``) counts as the ``dot_general`` it is in JAX, and a
transposed convolution as JAX prices the input-dilated convolution it
lowers to: 2 x output elements x input channels per group x kernel taps.
Elementwise and reduction work is excluded, as there, and so are the
registry's other formulas (attention library calls, fp8 products, backward
passes). A ``vtt`` operator counts once, by its formula, on the card and on
the CPU alike, so the kernel route and the plain route of a model give one
count.

As the JAX counter traces without running, ``fn`` runs on fake tensors
(``FakeTensorMode``): the arguments become fakes of their shapes, types
and devices, the model's weights are read as constants, and nothing is
computed; a ``vtt`` operator runs its fake implementation. A full-width
forward is counted in the seconds its trace takes, on either device.
"""

from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from ..ops.cuda import library  # noqa: F401  (registers the vtt formulas)

__all__ = ["count_flops"]

_aten = torch.ops.aten
# the default registry's matrix products and forward convolutions
_COUNTED = {
    _aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
    _aten.convolution, _aten._convolution, _aten.cudnn_convolution, _aten.convolution_overrideable,
    _aten._slow_conv2d_forward,
}


def _counted(op) -> bool:
    packet = getattr(op, "overloadpacket", op)
    return packet in _COUNTED or getattr(packet, "_qualified_op_name", "").startswith("vtt::")


def _conv(x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed, *args, out_shape=None, **kwargs) -> int:
    """2 x output elements x input channels per group x taps; the torch
    weight is (Cout, Cin / g, *k), or (Cin, Cout / g, *k) transposed."""
    groups = args[-1] if args else 1
    cin = w_shape[0] // groups if transposed else w_shape[1]
    return 2 * math.prod(out_shape) * cin * math.prod(w_shape[2:])


def _convolution(x_shape, w_shape, bias, stride, padding, dilation, transposed, output_padding, groups, *args,
                 out_shape=None, **kwargs) -> int:
    return _conv(x_shape, w_shape, bias, stride, padding, dilation, transposed, groups, out_shape=out_shape)


def _mv(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * math.prod(a_shape)  # (M, K) x (K,) and (K,) . (K,) alike


_OWN = {_aten.convolution: _convolution, _aten._convolution: _convolution, _aten.mv: _mv, _aten.dot: _mv}


def count_flops(fn, *args, **kwargs) -> float:
    """Total matmul + conv FLOPs of one call of ``fn(*args, **kwargs)``,
    traced on fake tensors (without autograd)."""
    mode = FlopCounterMode(display=False, custom_mapping=_OWN)
    mode.flop_registry = {op: f for op, f in mode.flop_registry.items() if _counted(op) or op in _OWN}
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        args, kwargs = pytree.tree_map_only(torch.Tensor, fake.from_tensor, (args, kwargs))
        with torch.no_grad(), mode:
            fn(*args, **kwargs)
    return float(mode.get_total_flops())
