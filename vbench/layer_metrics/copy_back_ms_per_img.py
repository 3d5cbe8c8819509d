"""copy_back_ms_per_img (ms, host clock; serving: serve.py ``_to_host``):
the batch worker's ``serve.copy_back`` spans (the answers' ``.cpu()`` into
host memory, after ``serve.wait`` has waited for the card) summed over
their parts inside the window, over the images answered in it.

The program's spans (vision_tpu_torch/utils/profiling.py ``spans()``) are
read after the run; the helpers here serve the other span readers too.
On a program without the recorder, or when its ring evicted records that
may fall inside the window, a reader returns None."""

import sys


def program_spans(ctx):
    """The program's span records, or None (see the module's docstring)."""
    try:
        from vision_tpu_torch.utils.profiling import dropped, spans
    except ImportError:
        return None
    records, lost = spans(), dropped()
    # the ring keeps the newest records: a lost one ended before the oldest kept
    if lost and (not records or records[0][3] > ctx.record.t_open * 1e9):
        print(f"vbench: the program's span ring dropped {lost} records, some inside the window; "
              "span metrics not read", file=sys.stderr, flush=True)
        return None
    return records


def window_ns(ctx) -> tuple[int, int]:
    return int(round(ctx.record.t_open * 1e9)), int(round(ctx.record.t_close * 1e9))


def ms_per_img(ctx, name: str):
    """The spans called ``name``, by their parts inside the window, in ms
    over the images answered in it; None where there is none."""
    records = program_spans(ctx)
    images = len(ctx.record.completed_in_window())
    if records is None or not images:
        return None
    lo, hi = window_ns(ctx)
    parts = [min(r[3], hi) - max(r[2], lo) for r in records if r[1] == name]
    parts = [p for p in parts if p > 0]
    return sum(parts) / 1e6 / images if parts else None


def read(ctx):
    return ms_per_img(ctx, "serve.copy_back")
