"""solves_per_s (end to end, host clock): closed-loop ticks completed in
the window over the window's seconds; on several chips the ticks the ranks
completed in lockstep over the window as the slowest rank ends it."""


def read(ctx):
    w = ctx.window
    return w["ticks"] / w["window_s"]
