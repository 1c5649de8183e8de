"""The program's own span store (``opendog_tpu_torch.utils.profiling.SPANS``),
read in the rank process after its window.  Host spans and the device times
of each replay carry the host start of their replay on the profiler's clock
(Unix ns), so the ticks the profiler traced (``bench.window``, ``[lo, hi]``)
are told from the rest: the readers take the untraced ticks, warm-up and
window alike, and their medians, which the graph's first replay and the
profiler's warm-up tick do not move.  A program without the store (an
earlier commit) reads None."""
import numpy as np


def store():
    try:
        from opendog_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "SPANS", None)


def untraced(ctx, rows):
    """The values of ``rows`` ((replay start ns, value)) outside the traced
    window; None without a trace to tell them apart."""
    if ctx.trace is None:
        return None
    lo, hi = ctx.trace.lo, ctx.trace.hi
    return [v for t, v in rows if not lo <= t <= hi]


def device_median(ctx, name):
    """Median device ms of span ``name`` over the untraced replays."""
    spans = store()
    if spans is None:
        return None
    ms = untraced(ctx, spans.device(name))
    return float(np.median(ms)) if ms else None
