"""img_s (images/s, host clock): answers that came back inside the measured
window, over the window's seconds. What a batch user pays a card for."""


def read(ctx):
    return len(ctx.record.completed_in_window()) / ctx.seconds
