"""The first card's idle time that falls to the renderer's host steps, in
ms a profiled frame: the idle gaps the trace's reduction gives to the
program's ``rt.render.*`` (finalize, pull), ``rt.mega.*`` (K1's launch)
and ``rt.mesh.*`` (the four-card launch and gather) spans, over the
profiled frames. One reader for ``render_gap_ms_per_frame.offline`` and
``.x4``."""

from rtbench import program

RENDERER = ("rt.render.", "rt.mega.", "rt.mesh.")


def read(ctx):
    if program.span_ms(ctx) is None:
        return None
    idle_s = sum(s for name, s in ctx.summary.gaps.items() if name.startswith(RENDERER))
    return program.per_frame(ctx, idle_s * 1e3)
