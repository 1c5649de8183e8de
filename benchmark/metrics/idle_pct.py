"""idle_pct (layer: device; device trace): the share of the traced window
(the harness's ``bench.window`` range, from the first traced tick's
dispatch to the last one's control on the host) in which no operation runs
on the device: 100 x (1 - the union of the kernels', copies' and fills'
intervals / the window's length).  Both come from the one trace, so the
share lies in [0, 100].  The tracer stretches the gaps between a replayed
graph's kernels, so a traced window reads idler than an untraced tick."""
ACROSS = "mean"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
