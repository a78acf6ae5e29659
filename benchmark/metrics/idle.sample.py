"""The device's idle share of the traced slice of whole calls, in percent:
1 - (the union of the card's kernel, copy and set intervals, overlapping
streams once) / (the slice's wall time on the host clock)."""

from benchmark import devtrace


def read(ctx):
    if ctx.window["kind"] != "sample" or ctx.slice is None:
        return None
    return 100.0 * devtrace.idle_share([(a, b) for _, a, b in ctx.slice["device"]], ctx.slice["wall_s"])
