"""Summarise a ``torch.profiler`` capture of the PyTorch port: the top ops
by self time on each device, with their share of that device's time.

    python -m image_restoration_sde_tpu_torch.trace_summary <dir or trace.json> [--top 20] [--device cuda:0]

Counterpart of ``tools/trace_summary.py``, for the Chrome trace that
``utils.profiling.trace`` writes (``torch.profiler``'s
``export_chrome_trace``; ``bench_train``'s ``BENCH_TRACE``).  The card's
events (kernels, copies and sets, ``args.device`` naming the card) are
grouped per card; each runs alone on its stream, so its self time is its
duration.  A capture with no card events (the CPU) is summarised from its
host operators, a parent's self time being its duration less its direct
children's on the same thread.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CATEGORIES = (  # (substring of the lower-cased name, category), first match
    ("irsde", "port kernel"),
    ("nccl", "collective"), ("all_reduce", "collective"), ("allreduce", "collective"), ("gloo", "collective"),
    ("memcpy", "copy"), ("memset", "copy"), ("copy", "copy"),
    ("conv", "conv"), ("cudnn", "conv"), ("implicit_gemm", "conv"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("xmma", "matmul"), ("mm", "matmul"), ("matmul", "matmul"),
    ("reduce", "reduce"), ("softmax", "reduce"), ("norm", "reduce"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
)

Totals = Dict[str, List[float]]  # op name -> [self microseconds, count]


def category(name: str) -> str:
    low = name.lower()
    return next((cat for key, cat in CATEGORIES if key in low), "other")


def load_events(path: str) -> list:
    """The complete ("X") events of a trace file, or of the newest
    ``*.json`` under a directory."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True), key=os.path.getmtime)
        if not files:
            raise FileNotFoundError(f"no trace .json under {path}")
        path = files[-1]
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_totals(events: list) -> Dict[str, Totals]:
    """Per card (``cuda:<n>``): each event name's summed duration and count."""
    out: Dict[str, Totals] = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            t = out[f"cuda:{(e.get('args') or {}).get('device', 0)}"][e["name"]]
            t[0] += float(e["dur"])
            t[1] += 1
    return out


def host_totals(events: list) -> Totals:
    """The host operators' (``cpu_op``) self times: on each thread, an
    event's duration less its direct children's."""
    by_thread = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out: Totals = defaultdict(lambda: [0.0, 0])
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: List[Tuple[float, list]] = []  # (end, [name, self])
        for e in evs:
            ts, dur = float(e["ts"]), float(e["dur"])
            while stack and stack[-1][0] <= ts:
                _close(out, stack.pop()[1])
            if stack:
                stack[-1][1][1] -= dur
            stack.append((ts + dur, [e["name"], dur]))
        while stack:
            _close(out, stack.pop()[1])
    return out


def _close(out: Totals, entry: list) -> None:
    t = out[entry[0]]
    t[0] += max(entry[1], 0.0)
    t[1] += 1


def summarize(events: list) -> Dict[str, Totals]:
    """``{device: totals}``: the cards' events, else the host's operators
    under ``cpu``."""
    cards = device_totals(events)
    return dict(cards) if cards else {"cpu": host_totals(events)}


def report(totals: Dict[str, Totals], top: int = 20, device: Optional[str] = None) -> str:
    lines = []
    for dev, ops in sorted(totals.items()):
        if device and device != dev:
            continue
        total = sum(t[0] for t in ops.values())
        if not total:
            continue
        by_cat = defaultdict(float)
        for name, (us, _) in ops.items():
            by_cat[category(name)] += us
        lines.append(f"\n== {dev}  (self time {total / 1e3:.3f} ms)")
        lines.append("   by category: " + ", ".join(f"{c} {100 * v / total:.1f}%"
                                                    for c, v in sorted(by_cat.items(), key=lambda kv: -kv[1])))
        lines.append(f"   {'self ms':>9}  {'%':>5}  {'count':>6}  op")
        for name, (us, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]:
            lines.append(f"   {us / 1e3:9.3f}  {100 * us / total:5.1f}  {n:6d}  {name[:110]}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a trace .json or the directory given to utils.profiling.trace")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default=None, help="one device (cuda:0, cpu); default all")
    args = ap.parse_args(argv)
    totals = summarize(load_events(args.trace))
    text = report(totals, args.top, args.device)
    if not text:
        print(f"no events for {args.device or 'any device'}; devices: {sorted(totals)}", file=sys.stderr)
        return 1
    print(f"# {args.trace}{text}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
