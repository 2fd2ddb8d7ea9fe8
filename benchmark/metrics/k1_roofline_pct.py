"""K1's share of its roofline, in percent: the least time of a frame's work
(``rtbench/work.py``: every primitive tested by every ray the reference
traces on the check rows, scaled to the frame) over K1's (``mega_kernel``)
device time a frame in the trace, summed over every card used. One reader
for ``k1_roofline_pct`` and its four-card split ``k1_roofline_pct.x4``."""

from rtbench import roofline


def read(ctx):
    return roofline.k1_pct(ctx)
