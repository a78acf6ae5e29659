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


def generators_for_seeds(seeds: Sequence[int], device="cuda") -> list:
    """One seeded generator per sample."""
    return [generator(s, device) for s in seeds]
