"""busy_ms_per_img.open (ms, device trace; the device): the card's busy time
in the traced window (the union of device operations' intervals) over the
requests answered in it: the card time an image costs, padding included."""


def read(ctx):
    win = ctx.window
    done = len(ctx.record.completed_in_window())
    if win is None or not done:
        return None
    return win.busy_ns / 1e6 / done
