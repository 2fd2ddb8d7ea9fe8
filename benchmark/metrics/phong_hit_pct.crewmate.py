"""The share of the regen loop's working lanes whose main hit is a Phong
surface, in percent: the program's counter ``regen.phong_hits`` (the valid
lanes on a Phong material, summed over the steps on the device) over
``regen.lanes_working`` (the lanes the loop test found working, summed
over the steps)."""

from rtbench import program


def read(ctx):
    c = program.counters(ctx) or {}
    hits, working = c.get("regen.phong_hits"), c.get("regen.lanes_working")
    if hits is None or not working:
        return None
    return 100.0 * hits / working
