"""tick_p95_ms (end to end, host clock): the 95th percentile over every
tick of the window of the host time from the tick's draw to its control
readable on the host; on several chips each tick at its slowest rank."""
from benchmark.harness.stats import percentile


def read(ctx):
    return 1e3 * percentile(ctx.window["latencies"], 95)
