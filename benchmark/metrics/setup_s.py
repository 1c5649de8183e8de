"""setup_s (end to end, host clock): from the start of the process to the
first timed tick (loading, the kernels' build where it is not cached, the
inputs, the start tick, the capture and the warm-up)."""


def read(ctx):
    return ctx.window["setup_s"]
