"""K2's share of its roofline in a frame of a configuration that names its
own reference module (``rtbench/offline_cfgref.py``), in percent:
``roofline.k2_pct`` itself, with the reference scene taken from that
module, whose loader reads the materials the plain reference's loader
refuses. The least time of the BVH walks that a frame's rays need
(``rtbench/work.py``: the visits of the benchmark's own tree over the
scene's triangles, walked by the reference's rays; counted on the check
rows and scaled to the frame) over K2's device time a frame in the trace."""

from rtbench import compare, offline_cfgref, roofline


def read(ctx):
    plain = compare.reference_scene
    compare.reference_scene = lambda c, dtype=None: offline_cfgref.reference_scene(c, dtype)[1]
    try:
        return roofline.k2_pct(ctx)
    finally:
        compare.reference_scene = plain
