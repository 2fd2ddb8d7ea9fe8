"""The host's time waiting on the device in the regen loop's tests, in ms
a profiled frame: the total duration of the program's ``rt.regen.sync``
spans over the profiled frames."""

from rtbench import program


def read(ctx):
    spans = program.span_ms(ctx) or {}
    return program.per_frame(ctx, spans.get("rt.regen.sync"))
