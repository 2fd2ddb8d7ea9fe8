"""Lanes whose state a gather moves, a profiled frame: the program's
counter ``regen.rows_gathered`` (the loop's width for each step that
permutes the lane state, the width each tail compaction compacts; counted
on the host) over the profiled frames. One reader for every cell's split
of the name."""

from rtbench import program


def read(ctx):
    c = program.counters(ctx) or {}
    return program.per_frame(ctx, c.get("regen.rows_gathered"))
