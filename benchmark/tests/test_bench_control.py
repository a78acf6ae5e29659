"""The control of ``correct`` at a size a test run holds: the reference in
the precision below the configuration's, put in the program's place, reads
well above the program on the same seeds (``calibrate.py`` on the CPU; the
readings the limits are set from are the chip's, at the cells' sizes)."""

import pytest

import tiny
from benchmark import calibrate


@pytest.mark.parametrize("cell", ["derain-sample-rain100h", "dehaze-sample-ntire-hr"])
def test_the_control_reads_above_the_program(tmp_path, cell):
    c = tiny.cell(tmp_path, cell)
    lines = calibrate.readings(c, 2**31 + 11, control=True, device="cpu")
    program, control = lines[0]["numbers"], lines[1]["numbers"]
    assert lines[1]["reading"] == "control float8_e4m3"
    assert any(control[k] > max(3 * program[k], c.limits[k]["limit"]) for k in program), (program, control)
