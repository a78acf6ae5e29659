"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[i]``) names a configuration (``configs/<config>.json``,
its plain reference ``reference/<config>.py``, and the system of its family
``systems/<system>.py`` that the file's ``system`` names) and a traffic mix
(``traffic/<mix>.json``, driven by the loop ``loops/<loop>.py`` that the
file's ``loop`` names); its limits of ``correct`` are
``limits/<cell>.json``; every metric, end to end or per layer, is read by
``metrics/<metric>.py``; a kernel's bytes and operations are
``work/<kernel>.py``.  New cells, configurations, families, mixes, loops
and metrics are new files and new entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    """A benchmark file loaded by its path (names may hold ``-`` and ``.``)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, name: str, base: Path = BENCH_DIR):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
        self.base = base
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = read_json(base / "configs" / f"{self.workload['config']}.json")
        self.traffic = read_json(base / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = read_json(base / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]

    def reference(self) -> ModuleType:
        return load_module(self.base / "reference" / f"{self.workload['config']}.py",
                           f"benchmark_reference_{self.workload['config']}")

    def system(self) -> ModuleType:
        name = self.config["system"]
        return load_module(self.base / "systems" / f"{name}.py", f"benchmark_system_{name}")

    def loop(self) -> ModuleType:
        name = self.traffic["loop"]
        return load_module(self.base / "loops" / f"{name}.py", f"benchmark_loop_{name}")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.base / "metrics" / f"{name}.py", f"benchmark_metric_{name}")

    def work(self, kernel: str) -> ModuleType:
        return load_module(self.base / "work" / f"{kernel}.py", f"benchmark_work_{kernel}")


def load(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    return Cell(read_json(bench_path), name)
