"""Restored images completed in the window over its seconds, from before
the first call to the synchronisation after the last."""

from benchmark import window


def read(ctx):
    w = ctx.window
    if w["kind"] != "sample":
        return None
    return window.rate(w["items"], w["start"], w["end"])
