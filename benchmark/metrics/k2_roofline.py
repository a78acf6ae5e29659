"""K2a and K2b, the packed linear attention's share of its roofline in the traced slice, in percent: the least
time of its calls there (``work/k2.py`` on the reference's sites of one
call or step, times the slice's calls; the port's launch counters must
count as many) over the profiler's device time of its kernels."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx, "k2")
