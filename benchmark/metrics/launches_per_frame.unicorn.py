"""Device kernel launches a traced frame of the regen engine, counted in
the trace (every ``kernel`` slice of the profiled frames)."""


def read(ctx):
    frames = ctx.out.get("traced_frames") or []
    if not frames or ctx.summary.kernel_us("bvh8_kernel")[1] == 0:
        return None
    return ctx.summary.launches / len(frames)
