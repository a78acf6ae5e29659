"""IR-SDE reverse samplers as Python loops (PyTorch).

Counterpart of the IR-SDE part of ``image_restoration_sde_tpu/sde/samplers.py``,
where each sampler is one ``lax.scan``.  Here the loop runs eagerly, one
network call per step.

``noise_fn(x, mu, tvec) -> noise`` is the conditional score network
(``score = -noise / sigma_bar``); ``tvec`` is an int ``(B,)`` tensor.

The stochastic samplers take either a generator (one, or one per sample) or
a pre-drawn ``noise_seq`` of shape ``(T, *x.shape)``, consumed t=T first.
``noise_seq`` lets tests thread the same noise through this package and the
JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .irsde import IRSDE
from .rng import GeneratorLike, normal_like

Tensor = torch.Tensor
CondNoiseFn = Callable[[Tensor, Tensor, Tensor], Tensor]


def _tvec(batch: int, t: int, device) -> Tensor:
    return torch.full((batch,), t, dtype=torch.int32, device=device)


def _loop_with_noise(step, x, T, gen, noise_seq, return_all):
    """Run ``step(x, t, z) -> x`` for t = T..1, with ``z`` from ``noise_seq``
    (row i for t = T - i) or drawn from ``gen``."""
    if noise_seq is not None and noise_seq.shape[0] != T:
        raise ValueError(f"noise_seq has {noise_seq.shape[0]} steps, expected {T}")
    states = []
    for i, t in enumerate(range(T, 0, -1)):
        z = noise_seq[i] if noise_seq is not None else normal_like(gen, x)
        x = step(x, t, z)
        if return_all:
            states.append(x)
    return (x, torch.stack(states)) if return_all else x


def reverse_sde(
    sde: IRSDE,
    noise_fn: CondNoiseFn,
    xt: Tensor,
    mu: Tensor,
    gen: Optional[GeneratorLike] = None,
    steps: Optional[int] = None,
    return_all: bool = False,
    noise_seq: Optional[Tensor] = None,
):
    """Euler–Maruyama reverse SDE, one net call per step."""
    T = sde.T if steps is None else steps
    batch = xt.shape[0]

    def step(x, t, z):
        noise_pred = noise_fn(x, mu, _tvec(batch, t, x.device))
        score = sde.score_from_noise(noise_pred, t)
        return sde.reverse_sde_step(x, mu, score, t, z)

    return _loop_with_noise(step, xt, T, gen, noise_seq, return_all)


def reverse_ode(
    sde: IRSDE,
    noise_fn: CondNoiseFn,
    xt: Tensor,
    mu: Tensor,
    steps: Optional[int] = None,
    return_all: bool = False,
):
    """Deterministic probability-flow ODE sampler."""
    T = sde.T if steps is None else steps
    batch = xt.shape[0]
    x = xt
    states = []
    for t in range(T, 0, -1):
        noise_pred = noise_fn(x, mu, _tvec(batch, t, x.device))
        score = sde.score_from_noise(noise_pred, t)
        x = sde.reverse_ode_step(x, mu, score, t)
        if return_all:
            states.append(x)
    return (x, torch.stack(states)) if return_all else x


def reverse_posterior(
    sde: IRSDE,
    noise_fn: CondNoiseFn,
    xt: Tensor,
    mu: Tensor,
    gen: Optional[GeneratorLike] = None,
    steps: Optional[int] = None,
    return_all: bool = False,
    noise_seq: Optional[Tensor] = None,
):
    """DDPM-style ancestral sampler (posterior sampling)."""
    T = sde.T if steps is None else steps
    batch = xt.shape[0]

    def step(x, t, z):
        noise_pred = noise_fn(x, mu, _tvec(batch, t, x.device))
        return sde.reverse_posterior_step(x, mu, noise_pred, t, z)

    return _loop_with_noise(step, xt, T, gen, noise_seq, return_all)
