"""Whole runs of each cell at a tiny size on the CPU (past the look for a
chip), with the timed path broken underneath: ``correct`` comes out
false for each fault the cell can have.  The cells sample and do not train
(no state a step, no mean over a batch), and run on one chip (no exchange
between chips): an answer altered where it is produced is their fault."""

import pytest

import tiny
from benchmark import harness


def run(tmp_path, cell, seed=12345):
    return harness.run(tiny.cell(tmp_path, cell), seed, 0.3, False, "cpu", 0.0)


def altered(fn):
    """``fn`` whose answers are altered where they are produced: each turned
    upside down, a wrong image of the right statistics."""

    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs).flip(1)

    return wrapper


@pytest.mark.parametrize("cell, module, name", [
    ("derain-sample-rain100h", "image_restoration_sde_tpu_torch.sde.samplers", "reverse_sde"),
    ("dehaze-sample-ntire-hr", "image_restoration_sde_tpu_torch.sde.samplers", "reverse_posterior"),
])
def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch, cell, module, name):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, altered(getattr(mod, name)))
    line = run(tmp_path, cell)
    assert line["correct"] is False, line["checked"]
