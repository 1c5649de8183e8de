"""collective_bytes_per_tick (layer: multi-device; program counter): the
bytes the program's collectives hand to ``all_reduce`` in one tick
(``parallel.collectives.TRAFFIC`` over the eager start tick: the counter
does not count graph replays)."""
ACROSS = "max"


def read(ctx):
    if ctx.facts["world"] < 2:
        return None
    return float(ctx.facts["collective_bytes_per_tick"])
