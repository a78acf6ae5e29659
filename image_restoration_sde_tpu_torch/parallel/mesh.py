"""The ``(data, model)`` layout of the ranks: data parallelism over one
axis, tensor parallelism over the other.

Counterpart of ``image_restoration_sde_tpu/parallel/mesh.py``'s
``make_mesh``.  The JAX package reshapes its devices to ``(n // tp, tp)``
and lets GSPMD place the collectives; here :func:`make_mesh` lays
``torchrun``'s ranks out the same way, rank r at data index ``r // tp``
and model index ``r % tp``, and builds one process group per line of the
grid: the ranks of a *model group* (one data index) hold the shards of one
copy of the net and run its split layers' collectives
(``parallel/tensor.py``); the ranks of a *data group* (one model index)
hold the same shard and average its gradients (DDP), each on its block of
the global batch's rows.

With ``model_parallel`` 1 the layout makes no group: every rank is a data
rank over the whole world, as without a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch.distributed as tdist

from . import dist

DATA_AXIS, MODEL_AXIS = "data", "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, model)`` grid and its two groups
    (None: the whole world for ``data_group``, no group for
    ``model_group``)."""

    data_rank: int
    data_size: int
    model_rank: int
    model_size: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_size}


def make_mesh(model_parallel: int = 1) -> Mesh:
    """Lay the process group's ranks out as ``(world // model_parallel,
    model_parallel)``, make the layout this process's (``dist``'s data
    axis: ``rows``, ``shard``, ``mean``) and return it.  Every rank must
    call it, with the same ``model_parallel``; a world size that
    ``model_parallel`` does not divide raises."""
    n, r, tp = dist.world_size(), dist.rank(), int(model_parallel)
    if tp < 1 or n % tp:
        raise ValueError(f"{n} process(es) not divisible by model_parallel={tp}")
    if tp == 1:
        mesh = Mesh(data_rank=r, data_size=n, model_rank=0, model_size=1)
    else:
        data_group = model_group = None
        # every rank creates every group, in one order (new_group is collective)
        for m in range(tp):
            group = tdist.new_group(list(range(m, n, tp)))
            if m == r % tp:
                data_group = group
        for d in range(n // tp):
            group = tdist.new_group(list(range(d * tp, (d + 1) * tp)))
            if d == r // tp:
                model_group = group
        mesh = Mesh(data_rank=r // tp, data_size=n // tp, model_rank=r % tp, model_size=tp,
                    data_group=data_group, model_group=model_group)
    dist.use_mesh(mesh)
    return mesh
