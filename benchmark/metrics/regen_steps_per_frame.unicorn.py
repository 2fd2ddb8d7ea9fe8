"""The regen engine's loop iterations a profiled frame: the program's
counter ``regen.steps`` over the profiled frames."""

from rtbench import program


def read(ctx):
    c = program.counters(ctx) or {}
    return program.per_frame(ctx, c.get("regen.steps"))
