"""mfu (%, host clock; model step: the model's forward_u8 behind
core/graph.py): the plain reference's FLOPs (matrix products and
convolutions, counted once on meta tensors) of the images answered in the
window, over the window's seconds and the card's dense bf16 peak (989
TFLOP/s for an H100 SXM). The whole step's share of the chip's peak, which
bounds what any kernel's roofline can add to img_s."""


def read(ctx):
    peaks = ctx.peaks
    if peaks is None or ctx.flops_per_image is None:
        return None
    flops = 0.0
    for k, *_ in ctx.record.completed_in_window():
        w, h, _ = ctx.traffic.extents[k]
        flops += ctx.flops_per_image((int(w), int(h)))
    return 100.0 * flops / ctx.seconds / peaks["bf16_flops"]
