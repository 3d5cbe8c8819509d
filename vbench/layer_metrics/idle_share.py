"""idle_share (%, device trace; the device): 1 minus the union of every
device operation's interval (kernels, copies, sets) over the traced window,
which the window's marker kernels bound in the device's clock."""


def read(ctx):
    win = ctx.window
    if win is None or win.close_ns <= win.open_ns:
        return None
    return 100.0 * (1.0 - win.busy_ns / (win.close_ns - win.open_ns))
