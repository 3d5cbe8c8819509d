"""A kernel's share of its roofline over the traced window.

A per-layer reader names the kernel-name patterns it reads from the trace
and gives, for one forward of the configuration at an input shape, the work
of each launch the forward needs: ``(tensor FLOPs, float32 FLOPs, bytes)``,
counted from the configuration's shapes (inputs read once, outputs written
once), whatever kernel implements it. A launch's least time is the largest
of tensor FLOPs / the bf16 peak, float32 FLOPs / the float32 peak and bytes
/ the memory bandwidth. The share is the least time of the launches traced
in the window over their device time: the launches counted in the trace,
each at the mean least time of a launch of the forwards that ran in the
window (their shapes from the host spans).
"""

from __future__ import annotations

import numpy as np

__all__ = ["share"]


def share(ctx, patterns, launches):
    win, spans, peaks = ctx.window, ctx.spans, ctx.peaks
    if win is None or spans is None or peaks is None:
        return None
    mask = win.matching(patterns)
    if not mask.any():
        return None
    shapes = [s for a, _, s in spans.forwards if win.open_ns <= win.host_to_device(a) < win.close_ns]
    shapes = shapes or [s for _, _, s in spans.forwards]
    least, count = 0.0, 0
    for shape in shapes:
        for tensor_flops, f32_flops, nbytes in launches(ctx.cfg, shape):
            least += max(tensor_flops / peaks["bf16_flops"], f32_flops / peaks["f32_flops"], nbytes / peaks["bytes"])
            count += 1
    if not count:
        return None
    device_s = float(np.sum(win.durations[mask])) / 1e9
    return 100.0 * int(mask.sum()) * (least / count) / device_s
