"""A copy of the benchmark's files at a size the CPU runs in seconds, for
the tests: the same cells, mixes and metrics, the networks cut to two
levels of width 16 and three SDE steps, the images to 14 x 18 px."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import spec

TINY_CONFIG = {
    "irsde-derain": {"score_net": {"setting": {"in_nc": 3, "out_nc": 3, "nf": 16, "depth": 2}}},
    "refusion-dehaze": {"score_net": {"setting": {"img_channel": 8, "width": 16, "middle_blk_num": 1,
                                                  "enc_blk_nums": [1, 4], "dec_blk_nums": [1, 1]}},
                        "compressor": {"setting": {"in_ch": 3, "out_ch": 3, "ch": 8, "ch_mult": [1, 2],
                                                   "embed_dim": 8}}},
}
TINY_TRAFFIC = {"size": [14, 18], "batch": 3}


def copy_tiny(dest: Path, steps: int = 3) -> dict:
    """The benchmark's folder copied to ``dest`` with tiny configurations;
    returns the parsed ``BENCHMARK.json``."""
    shutil.copytree(spec.BENCH_DIR, dest, ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    for name, change in TINY_CONFIG.items():
        path = dest / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        for part, values in change.items():
            config[part].update(values)
        config["sde"]["T"] = steps
        path.write_text(json.dumps(config))
    for path in (dest / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(TINY_TRAFFIC)
        path.write_text(json.dumps(traffic))
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def cell(tmp: Path, name: str) -> spec.Cell:
    return spec.Cell(copy_tiny(tmp / "bench"), name, base=tmp / "bench")
