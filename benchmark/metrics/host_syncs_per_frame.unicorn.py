"""Blocking readbacks a profiled frame: the program's counter
``host.syncs`` (each regen loop test and each pull of a frame's pixels)
over the profiled frames."""

from rtbench import program


def read(ctx):
    c = program.counters(ctx) or {}
    return program.per_frame(ctx, c.get("host.syncs"))
