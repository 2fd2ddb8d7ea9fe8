"""The share of the regen loop's lanes that hold work, in percent: the
program's counter ``regen.lanes_working`` (the lanes the loop test found
working, summed over the steps) over ``regen.lanes_stepped`` (the loop's
width, summed over the steps)."""

from rtbench import program


def read(ctx):
    c = program.counters(ctx) or {}
    working, stepped = c.get("regen.lanes_working"), c.get("regen.lanes_stepped")
    if working is None or not stepped:
        return None
    return 100.0 * working / stepped
