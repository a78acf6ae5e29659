"""Experiment logging: named python loggers + optional TensorBoard.

A copy of ``image_restoration_sde_tpu/utils/logging_utils.py``, whose
TensorBoard writer is ``torch.utils.tensorboard``'s here.

Parity: ref ``utils/file_utils.py:25-91`` — OrderedYaml (plain yaml here),
timestamped experiment-dir archiving (``mkdir_and_rename``), named "base" /
"val" loggers with file+screen handlers, TensorBoard scalars
(ref train.py:133-144).  TensorBoard goes through
``torch.utils.tensorboard`` when the tensorboard package is importable,
else a no-op writer.
"""

from __future__ import annotations

import logging
import os
import shutil
from datetime import datetime


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdir_and_rename(path: str) -> None:
    """Archive an existing experiment dir instead of clobbering it
    (ref file_utils.py:56-63)."""
    if os.path.exists(path):
        new_name = path + "_archived_" + get_timestamp()
        print(f"Path already exists. Rename it to [{new_name}]")
        shutil.move(path, new_name)
    os.makedirs(path, exist_ok=True)


def mkdirs(paths) -> None:
    if isinstance(paths, str):
        os.makedirs(paths, exist_ok=True)
    else:
        for p in paths:
            os.makedirs(p, exist_ok=True)


def setup_logger(
    logger_name: str,
    root: str,
    phase: str,
    level: int = logging.INFO,
    screen: bool = False,
    tofile: bool = False,
) -> logging.Logger:
    """Named logger with file/screen handlers (ref file_utils.py:73-91)."""
    lg = logging.getLogger(logger_name)
    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s", datefmt="%y-%m-%d %H:%M:%S"
    )
    lg.setLevel(level)
    lg.handlers.clear()
    lg.propagate = False  # absl/TF attach a root handler; avoid double lines
    if tofile:
        os.makedirs(root, exist_ok=True)
        log_file = os.path.join(root, f"{phase}_{get_timestamp()}.log")
        fh = logging.FileHandler(log_file, mode="w")
        fh.setFormatter(formatter)
        lg.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        lg.addHandler(sh)
    return lg


class TensorboardWriter:
    """``torch.utils.tensorboard`` scalar writer; no-ops without the
    tensorboard package."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._writer = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
