"""prep_ms_per_img (ms, host clock; serving: serve.py ``BatchServer``'s
prep pool): the ``serve.prep`` spans, each request's host preparation on a
prep-pool thread (Real-ESRGAN: ``Image.to_rgb_u8``), summed over their parts
inside the window, over the images answered in it."""

from vbench.layer_metrics.copy_back_ms_per_img import ms_per_img


def read(ctx):
    return ms_per_img(ctx, "serve.prep")
