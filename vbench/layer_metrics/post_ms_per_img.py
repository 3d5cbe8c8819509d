"""post_ms_per_img (ms, host clock; serving: each server's ``_run_group``
in serve.py): the batch worker's ``serve.post`` spans, the family's host
conversion of a batch's answers (Real-ESRGAN: the alpha channel's
concatenation and the ``Image`` of each), summed over their parts inside
the window, over the images answered in it."""

from vbench.layer_metrics.copy_back_ms_per_img import ms_per_img


def read(ctx):
    return ms_per_img(ctx, "serve.post")
