"""Data parallelism across processes: one process a card, started by
``torchrun``.

Counterpart of ``image_restoration_sde_tpu/parallel/mesh.py`` (the data
axis of the mesh) and of the process-group start of ``tools/train.py``.
The JAX package runs one program over a mesh and lets XLA insert the
gradient all-reduce; here, as in the reference (``torch.distributed.launch``,
DDP, ``DistIterSampler``), each process holds a full copy of the net and a
contiguous block of the global batch's rows, and DDP averages the gradients.

``torchrun --nproc_per_node N`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; :func:`init` reads
them.  Without them a process is alone: no process group, rank 0 of 1.
NCCL joins ranks on the card (one rank a card), gloo on the CPU; gloo also
all-reduces CUDA tensors, so ranks may share a card over gloo.

Under tensor parallelism (``parallel/mesh.py``) the ranks of one model
group hold one copy of the net between them: they load the same rows, draw
the same noise and report the same loss.  So the batch's rows
(:func:`rows`, :func:`shard`) and the mean of a metric (:func:`mean`) go
by the *data* axis of the layout :func:`use_mesh` set; without one, every
rank is a data rank.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as tdist

# how long a collective waits for its peers: long enough for rank 0 to
# validate or save alone while the others wait at a barrier
TIMEOUT = datetime.timedelta(hours=1)
BACKENDS = ("nccl", "gloo")
# the (data, model) layout of parallel.mesh.make_mesh; None: every rank a
# data rank of the whole world
_MESH = None


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process as a rank."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def process_is_primary() -> bool:
    """Rank 0 (or a process alone): the one that logs and writes."""
    return rank() == 0


def use_mesh(mesh) -> None:
    """Make ``mesh`` (a ``parallel.mesh.Mesh``, or None) this process's
    layout: its data axis sets the rows and the means below."""
    global _MESH
    _MESH = mesh


def data_rank() -> int:
    """This rank's index on the data axis (its rank without a mesh)."""
    return rank() if _MESH is None else _MESH.data_rank


def data_size() -> int:
    """The data axis's length: the copies of the net that split the batch."""
    return world_size() if _MESH is None else _MESH.data_size


def rows(global_batch: int) -> slice:
    """This rank's rows of a global batch: the contiguous block
    ``d * G / D .. (d + 1) * G / D`` of its data index d of D.  Raises where
    ``G`` does not divide by D."""
    n, d = data_size(), data_rank()
    if global_batch % n:
        raise ValueError(f"the global batch {global_batch} does not divide by {n} processes")
    local = global_batch // n
    return slice(d * local, (d + 1) * local)


def shard() -> Optional[tuple]:
    """``(data rank, data size)`` inside a process group, else None."""
    return (data_rank(), data_size()) if is_initialized() else None


def barrier() -> None:
    if is_initialized():
        if tdist.get_backend() == "nccl":
            tdist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            tdist.barrier()


def init(device: torch.device, backend: Optional[str] = None) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes and
    return this rank's device: ``cuda:LOCAL_RANK`` (made current) on the
    card, the CPU otherwise.  ``backend``: NCCL on the card and gloo on the
    CPU by default; gloo on the card lets several ranks share one card.

    A process that no launcher started, or that is in a group already,
    returns ``device`` as it is.  A rank that cannot join raises.  On the
    card, local rank 0 builds the kernels while the others wait at the
    aligning barrier, then every rank loads the built library."""
    device = torch.device(device)
    if is_initialized() or not launched():
        return device
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise RuntimeError(f"local rank {local} has no card of its own ({cards} card(s)): NCCL takes one "
                               f"rank a card; gloo lets ranks share one")
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("NCCL joins ranks on the card; the CPU takes gloo")
    tdist.init_process_group(backend, rank=rank_, world_size=world, timeout=TIMEOUT)
    if device.type == "cuda" and local == 0:
        from ..kernels import build

        build()
    barrier()
    return device


def shutdown() -> None:
    use_mesh(None)
    if is_initialized():
        tdist.destroy_process_group()


def mean(value: torch.Tensor) -> torch.Tensor:
    """``value`` averaged over the data axis (itself alone in one process;
    the ranks of a model group hold the same value)."""
    if not is_initialized() or data_size() == 1:
        return value
    total = value.detach().clone()
    tdist.all_reduce(total, group=None if _MESH is None else _MESH.data_group)
    return total / data_size()


def broadcast(obj):
    """Rank 0's ``obj`` on every rank."""
    if not is_initialized():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def gathered(indices: Sequence[int], fn: Callable) -> Iterator[tuple]:
    """``fn(i)`` for this rank's share of ``indices`` (every N-th, starting
    at its rank), gathered on rank 0: on rank 0 yields ``(i, fn(i))`` for
    every index in order, on the others nothing.  One gather per round of N
    items, so rank 0 holds one round's results at a time; every rank must
    run the generator to its end."""
    n, r = world_size(), rank()
    for start in range(0, len(indices), n):
        block = indices[start:start + n]
        mine = (block[r], fn(block[r])) if r < len(block) else None
        if n == 1:
            yield mine
            continue
        parts = [None] * n if r == 0 else None
        tdist.gather_object(mine, parts, dst=0)
        if r == 0:
            yield from (p for p in parts if p is not None)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(local: int, fn: Callable, world: int, port: int, device: str, backend, out_dir: str, args) -> None:
    os.environ.update(RANK=str(local), WORLD_SIZE=str(world), LOCAL_RANK=str(local), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dev = init(torch.device(device), backend)
    try:
        result = fn(dev, *args)
        torch.save(result, os.path.join(out_dir, f"{local}.pt"))
    finally:
        shutdown()


def spawn(fn: Callable, world: int, *args, device: str = "cuda", backend: Optional[str] = None) -> list:
    """Run ``fn(rank_device, *args)`` in ``world`` fresh processes that
    join one process group (as ``torchrun`` would start them, on this host)
    and return their results in rank order.  ``device``: the ranks' device,
    the card unless ``"cpu"`` is asked for (``init`` places each rank).
    ``fn`` and ``args`` are pickled (``fn`` by its import path); a rank
    that raises makes this raise."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="irsde_ranks_") as out_dir:
        mp.start_processes(_rank_main, args=(fn, world, free_port(), device, backend, out_dir, args), nprocs=world,
                           start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False) for r in range(world)]
