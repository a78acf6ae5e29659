"""Parallelism over ranks: data parallelism (``dist``), the ``(data,
model)`` layout (``mesh``) and tensor parallelism over its model axis
(``tensor``)."""

from . import dist, mesh, tensor
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "dist", "make_mesh", "mesh", "tensor"]
