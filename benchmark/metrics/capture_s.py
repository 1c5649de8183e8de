"""capture_s (layer: MPC loop and CUDA graph; host clock, the benchmark's
own): seconds of ``graph_tick`` (its eager warm-up and its capture) and the
first replay, to the synchronise."""
ACROSS = "max"


def read(ctx):
    return ctx.setup["capture_s"]
