"""A port kernel's share of its roofline in a traced slice."""

from __future__ import annotations

import sys

from . import devtrace
from .peaks import least_seconds


def share(ctx, kernel: str):
    """Percent, or None where the slice holds none of the kernel's work or
    the launch counters disagree with the reference's sites."""
    if ctx.slice is None or ctx.work is None or ctx.work[1] is None:
        return None
    work = ctx.cell.work(kernel)
    sites = [s for s in ctx.work[1] if s[0] == work.SITE]
    units = ctx.slice["units"]
    launched = sum(ctx.slice["launches"].get(sym, 0) for sym in work.SYMBOLS)
    if not sites or not launched:
        return None
    if launched != len(sites) * len(work.SYMBOLS) * units:
        print(f"benchmark: {kernel}: {launched} launches in the slice, the reference's sites give "
              f"{len(sites) * len(work.SYMBOLS) * units}; no roofline", file=sys.stderr)
        return None
    least = 0.0
    for site in sites:
        least += least_seconds(*work.work(site), ctx.peaks)
    seconds, count = devtrace.kernel_seconds(ctx.slice["device"], work.DEVICE_NAMES)
    if not count:
        return None
    return 100.0 * least * units / seconds
