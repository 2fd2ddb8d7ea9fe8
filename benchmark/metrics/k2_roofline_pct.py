"""K2's share of its roofline, in percent: the least time of the BVH walks
that a frame's rays need (``rtbench/work.py``: the visits of the
benchmark's own tree, walked by the reference's rays: nearest hits for the
main rays, any hit below the cap for the shadow rays; counted on the check
rows and scaled to the frame) over K2's device time a frame in the trace."""

from rtbench import roofline


def read(ctx):
    return roofline.k2_pct(ctx)
