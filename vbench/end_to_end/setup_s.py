"""setup_s (s, host clock): from the start of the process until the
measured window opens: imports, the CUDA context, the kernel library (built
by nvcc in the first run of a checkout), the weights and request images made
on the card, the model and server, every graph key captured, the lead-in."""


def read(ctx):
    return ctx.setup_s
