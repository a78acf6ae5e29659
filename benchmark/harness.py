"""One run of one cell: set-up, the measured window, the traced slice, the
comparison that decides ``correct``, and the result's line.

Order of a run: the cell's system is built and warmed up on its own shapes
(``setup_s``, from the start of this function to the synchronisation after
set-up, the port's import and any kernel build included); the window runs
``--seconds``; with ``--trace 1`` a bounded slice of whole calls
runs under ``torch.profiler`` and is reduced in the process; the peak
memory is read and the program's state freed; the reference checks what
the window produced; the last lines of standard error give each number
compared beside its limit, and the last line of standard output is the
result.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

from . import devtrace, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "image_restoration_sde_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache in a fixed directory of the checkout."""
    for var, sub in CACHE_DIRS.items():
        path = root / "benchmark" / "_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


class Context:
    """What the per-layer readers (``metrics/<name>.py``) read: the window,
    the traced slice, the work of a unit, the launches and the graphs."""

    def __init__(self, cell, system, window: dict, peaks: dict):
        self.cell, self.window, self.peaks = cell, window, peaks
        self.slice = None  # {"units", "items", "wall_s", "device", "host", "launches"}
        self.work = None  # (FLOP of a unit, kernel sites of a unit)
        self.graph_entries = system.graph_entries()
        self.setup_s = None


def launches() -> dict:
    from image_restoration_sde_tpu_torch.ops import KERNELS

    return {k.symbol: k.launches for k in KERNELS}


def traced_slice(system, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    labels = set()

    def record(label: str):
        labels.add(label)
        return record_function(label)

    before = launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = system.traced(record)
        wall = time.perf_counter() - t0
    after = launches()
    device_events, host_events = devtrace.from_profiler(prof, labels)
    return {**done, "wall_s": wall, "device": device_events, "host": host_events,
            "launches": {k: after[k] - before[k] for k in after}}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, reference=None) -> dict:
    """The result's line (a dict) of one run; ``device`` ``cuda`` or, for the
    CPU tests, ``cpu``."""
    import torch

    from . import cells, peaks as peak_table

    on_card = torch.device(device).type == "cuda"
    system = cells.make(cell, seed, device, reference)
    system.phases["imports"] = time.perf_counter() - t_start
    system.setup()
    cells.sync(device)
    setup_s = time.perf_counter() - t_start
    window = system.window(seconds)
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    ctx = Context(cell, system, window, peak_table.peaks(name) if on_card else peak_table.H100_SXM)
    ctx.setup_s = setup_s
    if trace:
        ctx.slice = traced_slice(system, device) if on_card else None
        ctx.work = system.flops_and_sites()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    system.free()
    if on_card:
        torch.cuda.empty_cache()
    checked = [(n, float(v), float(cell.limits[n]["limit"])) for n, v in system.check()]
    correct = all(v <= lim for _, v, lim in checked)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": correct, "attempted": int(window["attempted"]), "failed": int(window["failed"]),
            "metrics": metrics,
            "device": {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1,
                       "memory_peak_bytes": int(peak)}}
    if trace and ctx.slice is not None:
        dev = [(a, b) for _, a, b in ctx.slice["device"]]
        line["device"].update(busy_s=devtrace.busy(dev), window_s=ctx.slice["wall_s"])
        line["breakdown"] = {"device_ops": devtrace.top_ops(ctx.slice["device"]),
                             "idle_gaps": devtrace.labelled_gaps(dev, ctx.slice["host"])}
    line["checked"] = {n: {"value": v, "limit": lim} for n, v, lim in checked}
    line["setup_phases_s"] = system.phases
    return line


def main(argv=None) -> int:
    import argparse

    t_start = time.perf_counter()
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.load(args.workload)
    set_cache_dirs(spec.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    line = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; nothing on the chip may import JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    phases = line.pop("setup_phases_s")
    print("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    for name, c in line["checked"].items():
        print(f"checked {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    checked = line.pop("checked")
    print(json.dumps({**line, "checked": checked}), flush=True)
    return 0
