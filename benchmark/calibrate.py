#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the chip at
a cell's own size (``limits/<cell>.json`` records them).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control]

For each seed, in one process: the cell's run is built and warmed up as a
run builds it (without the first replay a run makes before its window),
the calls that a run compares are made by the program, and the comparison
is read (the lower readings: sound runs of the program).  With
``--control`` the reference in the precision just below the
configuration's (``reference/precision.py``) takes the program's place
(the upper readings).  One JSON line a seed and reading.  The benchmark's
runs do not run this.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import cells, harness, spec  # noqa: E402
from benchmark.reference.precision import Precision  # noqa: E402

CONTROL = {"bfloat16": "float8_e4m3"}


def control_precision(run) -> Precision:
    """The precision below the score net's stated compute dtype."""
    return Precision(CONTROL[run.config["score_net"]["compute_dtype"]])


def program_outputs(run) -> None:
    """The outputs a run keeps, made by the program outside any window: the
    calls a window of ``check_from`` calls would check, and only those."""
    run.choose(int(run.traffic["check_from"]))
    for i, rows in run.rows.items():
        run.kept[i] = run.call(i)[rows]
    cells.sync(run.device)


def control_outputs(run, prec: Precision) -> None:
    """The reference in ``prec`` put in the program's place."""
    cells.reference_precision(run.device)
    run.kept = run.reference_outputs(run.reference(run.device, prec))


def readings(cell, seed: int, control: bool, device="cuda") -> list:
    import torch

    t0 = time.perf_counter()
    run = cells.make(cell, seed, torch.device(device))
    run.setup(first_call=False)
    program_outputs(run)
    out = [{"seed": seed, "reading": "program", "numbers": dict(run.check()), "s": time.perf_counter() - t0}]
    if control:
        prec = control_precision(run)
        control_outputs(run, prec)
        out.append({"seed": seed, "reading": f"control {prec.name}", "numbers": dict(run.check())})
    run.free()
    del run
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as each run starts
    return out


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args()
    cell = spec.load(args.workload)
    harness.set_cache_dirs(spec.ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(cell, seed, args.control):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
