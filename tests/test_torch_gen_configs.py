"""The port's config generator against the repository's tool: ``python -m
image_restoration_sde_tpu_torch.gen_configs --out DIR`` writes the files of
``tools/gen_configs.py`` byte for byte.  The tool is loaded from its file
with its ``ROOT`` pointed at a temporary directory, never at ``configs/``."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

from image_restoration_sde_tpu_torch import gen_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root):
    files = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


def _tool(root):
    spec = importlib.util.spec_from_file_location("tool_gen_configs", os.path.join(REPO, "tools", "gen_configs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.ROOT = root
    return tool


def test_generator_writes_the_tools_bytes(tmp_path, capsys):
    want_root, got_root = str(tmp_path / "tool"), str(tmp_path / "port")
    tool = _tool(want_root)
    tool.main()
    assert gen_configs.main(["--out", got_root]) == 0
    assert f"wrote {len(tool.CONFIGS)} configs under {got_root}" in capsys.readouterr().out
    want, got = _tree(want_root), _tree(got_root)
    assert len(want) == len(tool.CONFIGS) == len(gen_configs.CONFIGS)
    assert sorted(got) == sorted(want)
    assert [name for name in want if got[name] != want[name]] == []


def test_entry_point_defaults_to_the_repositorys_configs(tmp_path):
    """``--out`` defaults to ``configs/`` (as the tool's ``ROOT``); run as
    a module with ``--out`` it writes there and nowhere else."""
    assert os.path.samefile(gen_configs.ROOT, os.path.join(REPO, "configs"))
    out = tmp_path / "configs"
    run = subprocess.run([sys.executable, "-m", "image_restoration_sde_tpu_torch.gen_configs", "--out", str(out)],
                         cwd=str(tmp_path), capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert f"wrote {len(gen_configs.CONFIGS)} configs" in run.stdout
    assert sorted(os.listdir(tmp_path)) == ["configs"]
    assert sorted(_tree(str(out))) == sorted(gen_configs.CONFIGS)
