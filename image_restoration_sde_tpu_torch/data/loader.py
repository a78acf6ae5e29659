"""Input pipeline: sharded, seeded, thread-prefetched batch iterators.

A copy of ``image_restoration_sde_tpu/data/loader.py`` with three changes:
the process index and count are the data axis's (``parallel.dist``:
``torch.distributed``'s rank and world size when it is initialised, else 0
of 1; under tensor parallelism the ranks of a model group share one); a process takes a contiguous block of each
global batch's rows, not every N-th sample; and a train loader can start at
any step (``start_step``), so a resumed run reads the batches an
uninterrupted run would have read.

Replaces torch DataLoader + DistIterSampler (ref data/__init__.py:8-33,
data/data_sampler.py:13-68) with a host-side pipeline that feeds the
accelerator:

- **Epoch enlargement**: like DistIterSampler's ``ratio`` (drivers pass
  200/1000), one "epoch" is ``ratio * len(dataset)`` samples so the
  iter-oriented training loop rarely re-shuffles.
- **Determinism**: shuffles are seeded by (seed, epoch); per-sample
  augmentation RNG is seeded by (seed, epoch, index-position) through
  ``dataset.set_epoch_seed``.
- **Host sharding**: per-process batch = global_batch / process_count
  (ref data/__init__.py:11-16); process r takes rows r * local ..
  (r + 1) * local of each global batch of the one-process loader, so the
  processes' batches, put together in rank order, are the one-process
  batch row for row (the train step's draws, made for the global batch on
  every process, pair with the same images).
- **Thread-pool decode + prefetch**: cv2/numpy release the GIL; a small
  executor decodes ahead of the train step so the card never waits.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class TrainLoader:
    """Infinite iterator of train batches (drop_last semantics)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        ratio: int = 1,
        num_workers: int = 8,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        start_step: int = 0,
    ):
        if batch_size % process_count != 0:
            raise ValueError(f"the global batch {batch_size} does not divide by {process_count} processes")
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.seed = seed
        self.ratio = max(1, int(ratio))
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.start_step = start_step

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        total = n * self.ratio
        rng = np.random.default_rng((self.seed, epoch))
        idx = rng.permutation(total) % n  # DistIterSampler: shuffled, mod n
        usable = (len(idx) // self.global_batch) * self.global_batch
        first = self.process_index * self.local_batch
        return idx[:usable].reshape(-1, self.global_batch)[:, first : first + self.local_batch]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        stop = threading.Event()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        def producer():
            epoch, skip = divmod(self.start_step, self.steps_per_epoch())
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not stop.is_set():
                    if hasattr(self.dataset, "set_epoch_seed"):
                        self.dataset.set_epoch_seed((self.seed, epoch))
                    for batch_idx in self._epoch_indices(epoch)[skip:]:
                        samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                        batch = _collate(samples)
                        while not stop.is_set():
                            try:
                                q.put(batch, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                    epoch, skip = epoch + 1, 0

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    def steps_per_epoch(self) -> int:
        return len(self._epoch_indices(0))


class EvalLoader:
    """Sequential batch-1 iterator (ref data/__init__.py:30-33)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def batch(self, i: int) -> Dict[str, Any]:
        """Image ``i`` as a batch of one."""
        if hasattr(self.dataset, "set_epoch_seed"):
            self.dataset.set_epoch_seed(None)
        return _collate([self.dataset[i]])

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield self.batch(i)


def process_index_and_count() -> tuple:
    """(index, length) of this process on the data axis (``parallel.dist``:
    the rank and world size of ``torch.distributed`` when it is initialised
    and no tensor-parallel layout is set, else (0, 1)); the ranks of a model
    group load the same rows."""
    from ..parallel import dist

    return dist.data_rank(), dist.data_size()


def create_dataloader(dataset, dataset_opt, opt=None, seed: int = 0, ratio: int = 1, start_step: int = 0):
    """Reference-shaped factory (ref data/__init__.py:8-33)."""
    phase = dataset_opt.get("phase", "train")
    if phase == "train":
        index, count = process_index_and_count()
        return TrainLoader(
            dataset,
            batch_size=int(dataset_opt["batch_size"]),
            seed=seed,
            ratio=ratio,
            num_workers=int(dataset_opt.get("n_workers") or 8),
            process_index=index,
            process_count=count,
            start_step=start_step,
        )
    return EvalLoader(dataset)
