"""The share of the regen loop's steps that ran as a replay of a captured
CUDA graph, in percent: the program's counter ``regen.graph_steps`` over
``regen.steps``."""

from rtbench import program


def read(ctx):
    c = program.counters(ctx) or {}
    graphed, steps = c.get("regen.graph_steps"), c.get("regen.steps")
    if graphed is None or not steps:
        return None
    return 100.0 * graphed / steps
