"""Normal draws from explicit ``torch.Generator`` objects.

A sampler draws from ONE generator for the whole batch, or from a sequence
of generators, one per sample: sample i's noise then depends only on
generator i, whatever the batch composition or chunking.

The JAX package draws from threefry keys, which PyTorch cannot reproduce, so
the same seed gives different noise in the two packages by design.  Tests
that compare the packages feed both the same numpy-made noise instead.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

GeneratorLike = Union[torch.Generator, Sequence[torch.Generator]]


def is_generator_batch(gen) -> bool:
    """True iff ``gen`` is a per-sample sequence of generators."""
    return isinstance(gen, (list, tuple))


def normal_like(gen: GeneratorLike, x: torch.Tensor) -> torch.Tensor:
    """N(0, 1) of ``x``'s shape, dtype and device; per sample when ``gen`` is
    a sequence of generators (one per leading-axis entry of ``x``)."""
    if is_generator_batch(gen):
        if len(gen) != x.shape[0]:
            raise ValueError(f"{len(gen)} generators for a batch of {x.shape[0]}")
        return torch.stack(
            [
                torch.randn(x.shape[1:], generator=g, dtype=x.dtype, device=x.device)
                for g in gen
            ]
        )
    return torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)


def generator(seed: int, device="cuda") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def fold_seed(seed: int, index: int) -> int:
    """The seed of item ``index`` (a tile of an image, an image of a test
    set) of a run seeded with ``seed``: items draw independent noise, and
    an item's noise does not depend on how the items are batched."""
    return int(np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)[0])


def draw_rows(local: int, shard=None) -> tuple:
    """``(rows kept, batch drawn)`` for a train step whose batch holds
    ``local`` rows: all of them alone; with ``shard = (rank, world)`` the
    draws cover the global batch of ``world * local`` rows, what one process
    would draw, and rank keeps its contiguous block.  Every rank then draws
    the same, so their generators stay equal."""
    if shard is None:
        return slice(None), local
    rank, world = shard
    return slice(rank * local, (rank + 1) * local), world * local


def draw_states(gen: torch.Generator, T: int, x0: torch.Tensor, shard=None) -> tuple:
    """A train step's draws for the batch ``x0`` (its shape and device), in
    this order from ``gen``: per-example timesteps t ~ U{1..T}, ``(B, 1, 1,
    1)`` int64, then N(0, 1) noise of ``x0``'s shape, float32; with
    ``shard`` the global batch's (:func:`draw_rows`), this rank's rows
    kept.  The SDEs compose the noisy states from them
    (``compose_states``): a captured train step reads the draws from
    buffers filled before each replay."""
    rows, batch = draw_rows(x0.shape[0], shard)
    timesteps = torch.randint(1, T + 1, (batch, 1, 1, 1), generator=gen, device=x0.device)[rows]
    noises = torch.randn((batch, *x0.shape[1:]), generator=gen, dtype=torch.float32, device=x0.device)[rows]
    return timesteps, noises


def generators_for_seeds(seeds: Sequence[int], device="cuda") -> list:
    """One seeded generator per sample."""
    return [generator(s, device) for s in seeds]
