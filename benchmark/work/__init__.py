"""Each port kernel's bytes and operations, from the shapes of its call.

``work/<kernel>.py`` holds ``SYMBOLS`` (the port's launch counters that
count its launches), ``DEVICE_NAMES`` (what the profiler calls its device
kernels), ``SITE`` (the reference's site tag, ``reference/nets.py``) and
``work(site) -> (bytes, [(operations, peak key), ...])``: the least the
operator's call must move and compute at those shapes, whatever implements
it, each input byte read once and each output byte written once.  Each
part of the arithmetic is priced at the fastest rate the card offers for
it (``peaks.py``): products of bfloat16 operands on the bfloat16 tensor
cores, of float32 operands at TF32's rate, the rest (norms, gates,
softmaxes, depthwise convolutions) at the float32 rate.
"""


def product_peak(itemsize: int) -> str:
    """The peak a product of operands of ``itemsize`` bytes runs at."""
    return "bfloat16" if itemsize == 2 else "tf32"
