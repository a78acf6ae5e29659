"""The whole call's share of the card's bf16 dense peak, in percent: the
reference's FLOP of one call (``FlopCounterMode`` on the benchmark's own
reference at the cell's shapes; a chain step's part times its steps), times the window's calls, over the
window's seconds and the peak."""


def read(ctx):
    w = ctx.window
    if w["kind"] != "sample" or ctx.work is None:
        return None
    flops = ctx.work[0] * w["units"]
    return 100.0 * flops / ((w["end"] - w["start"]) * ctx.peaks["bfloat16"])
