"""The server's own time a request, in ms: the mean, over the traced
requests, of the span of ``RenderJob.run`` less the spans of the
``render_band_sums`` calls inside it (each span ends when the band's
kernels have finished). What is left is the server's planning, finalize
hand-off, packing, sending and waits between them."""


def read(ctx):
    jobs = ctx.out.get("job_spans") or []
    if not jobs:
        return None
    return sum(run - bands for run, bands in jobs) / len(jobs) * 1e3
