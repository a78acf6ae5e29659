"""Data parallelism across cards (``dist``).  Tensor parallelism is not
ported yet."""

from . import dist

__all__ = ["dist"]
