"""Percent of the traced window in which no device slice ran: one minus the
union of the device's slices over the window, the mean over the cards
used. One reader for the metric's split per cell (``device_idle_pct.offline``,
``.mesh``, ``.x4``, ``.served``), which the cells' entries select."""


def read(ctx):
    return (1.0 - ctx.summary.busy_share()) * 100.0
