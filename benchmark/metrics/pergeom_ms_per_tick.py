"""pergeom_ms_per_tick (layer: substep kernels; device trace): device time
per traced tick of the per-geom kernel (K4), the kernels named
``substep_pergeom*``: the rollouts' 25 launches and the plant's one."""
ACROSS = "mean"


def pergeom(name: str) -> bool:
    return name.startswith("substep_pergeom")


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels(pergeom):
        return None
    return 1e3 * ctx.trace.seconds(pergeom) / ctx.trace.ticks
