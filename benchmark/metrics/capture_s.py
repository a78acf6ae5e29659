"""Host seconds of the warm-ups and captures of every CUDA graph the cell's
system made (``sde/captured.py`` ``Captured.warm_s + capture_s``)."""


def read(ctx):
    entries = ctx.graph_entries
    if not entries:
        return None
    return sum(e.warm_s + e.capture_s for e in entries)
