"""The measured window's arithmetic: a rate over all its work and time.

A pure function of host-clock readings, so the CPU tests hold it on
synthetic timings.
"""

from __future__ import annotations


def rate(items: int, start: float, end: float) -> float:
    """Items completed in the window over its seconds, ``start`` before the
    first call and ``end`` after the synchronisation that follows the last
    one: a stall anywhere in it lowers the rate."""
    if end <= start:
        raise ValueError(f"a window of {end - start} s")
    return items / (end - start)
