"""Each cell's command on the card, briefly: one JSON line, correct, the
device named.  Marked ``cuda``; skips without a card (decided in the
fixture, never at import)."""

import json
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "1"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checked"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
