"""The regen engine's host time in its phases, in ms a profiled frame: the
total duration of the program's ``rt.regen.*`` spans other than
``rt.regen.sync`` (camera, sort, trace, shadow, shade, compact, scatter)
over the profiled frames. The profiler's cost a host op is inside it, so
it reads about twice the untraced frame's host time."""

from rtbench import program


def read(ctx):
    spans = program.span_ms(ctx)
    if spans is None:
        return None
    total = sum(ms for name, ms in spans.items()
                if name.startswith("rt.regen.") and name != "rt.regen.sync")
    return program.per_frame(ctx, total)
