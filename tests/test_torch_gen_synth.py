"""The port's demo-data generators against the repository's tools: for the
same arguments, ``gen_synth {dehaze,bokeh,stereo}`` and ``gen_masks`` write
the trees of ``tools/gen_synth_*.py`` and ``tools/gen_masks.py`` byte for
byte (every PNG and ``meta.txt``).  The tools run as they are, in their own
processes; the stereo tool takes the JAX package's ``imresize``, the port
its own ``data.imresize``."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from image_restoration_sde_tpu_torch import gen_masks, gen_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "dehaze": ("gen_synth_dehaze.py", ["--n-train", "2", "--n-val", "1", "--size", "64"]),
    "bokeh": ("gen_synth_bokeh.py", ["--n-train", "2", "--n-val", "1", "--size", "64"]),
    "stereo": ("gen_synth_stereo.py", ["--n-train", "2", "--n-val", "1", "--train-size", "64", "--val-size", "64"]),
    "masks": ("gen_masks.py", ["-n", "2"]),
}


def _tree(root):
    files = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


@pytest.mark.parametrize("kind", sorted(CASES))
def test_generators_write_the_tools_bytes(kind, tmp_path):
    tool, args = CASES[kind]
    want_root, got_root = str(tmp_path / "tool"), str(tmp_path / "port")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    subprocess.run([sys.executable, os.path.join(REPO, "tools", tool), "--out", want_root, *args], check=True,
                   env=env, cwd=str(tmp_path), capture_output=True)
    if kind == "masks":
        assert gen_masks.main(["--out", got_root, *args]) == 0
    else:
        assert gen_synth.main([kind, "--out", got_root, *args]) == 0
    want, got = _tree(want_root), _tree(got_root)
    assert want and sorted(got) == sorted(want)
    assert [name for name in want if got[name] != want[name]] == []
