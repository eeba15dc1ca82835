"""setup_s: seconds from the process's start to the window's first call:
imports, the kernels' build (or their cache), the inputs made from the
seed, the warm-up call of the cell's shape. Host clock."""


def read(ctx):
    return ctx.setup_s
