"""The profiler's slice reduced to the numbers the benchmark reports.

``torch.profiler`` traces a bounded slice of whole calls or steps (CUDA
graph replays included: the profiler sees each replayed kernel).  The
device's activity is the union of its kernel, copy and set intervals, so
two streams that overlap count once; the idle share is what that union
leaves of the slice's wall time on the host clock.  The idle gaps are
labelled with the innermost host event that spans each gap's middle (the
harness wraps its own phases in ``record_function``), or ``host idle``.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, merged intervals: overlaps and touching ends counted once."""
    merged: List[list] = []
    for a, b in sorted(intervals):
        if b < a:
            raise ValueError(f"interval ({a}, {b}) ends before it starts")
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def idle_share(intervals: Iterable[Interval], wall: float) -> float:
    """1 - busy / wall of the device's intervals over a slice of ``wall``."""
    if wall <= 0:
        raise ValueError(f"a slice of {wall}")
    return 1.0 - busy(intervals) / wall


def gaps(intervals: Iterable[Interval]) -> List[Interval]:
    """The idle stretches between the union's intervals."""
    u = union(intervals)
    return [(u[i][1], u[i + 1][0]) for i in range(len(u) - 1) if u[i + 1][0] > u[i][1]]


def top_ops(events: Sequence[Tuple[str, float, float]], n: int = 10) -> list:
    """``[[name, seconds], ...]``: the ``n`` device operations by summed time."""
    total = {}
    for name, a, b in events:
        total[name] = total.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def labelled_gaps(device: Sequence[Interval], host: Sequence[Tuple[str, float, float]], n: int = 10) -> list:
    """``[[label, seconds], ...]``: the ``n`` longest idle gaps, each by the
    innermost host event spanning its middle."""
    out = []
    for a, b in sorted(gaps(device), key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        spans = [(e - s, name) for name, s, e in host if s <= mid <= e]
        out.append([min(spans)[1] if spans else "host idle", b - a])
    return out


def kernel_seconds(events: Sequence[Tuple[str, float, float]], names: Sequence[str]) -> Tuple[float, int]:
    """(summed seconds, count) of the device events whose name holds one of
    ``names``."""
    hits = [(b - a) for name, a, b in events if any(k in name for k in names)]
    return sum(hits), len(hits)


def from_profiler(prof, labels: Sequence[str] = ()) -> Tuple[list, list]:
    """``(device events, host events)`` of a finished ``torch.profiler``
    session, each ``(name, start s, end s)`` on one clock.  The device's
    copies of the host's ``record_function`` ranges (``labels``) are no
    device work and are left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or e.name in labels):
                device.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    return device, host
