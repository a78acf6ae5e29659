"""The IR-SDE and denoising-SDE training steps (PyTorch).

Counterpart of ``image_restoration_sde_tpu/training/trainer.py``, which
replaces the reference's ``DenoisingModel.optimize_parameters`` (ref
denoising_model.py:127-148): sample per-example timesteps and noisy
states, run the score net, form the maximum-likelihood objective

    loss = w * || reverse_sde_step_mean(x_t, score, t)
                 - reverse_optimum_step(x_t, x_0, t) ||_1,

take grads, update the parameters in place, then the EMA where the task
keeps one (ema_pytorch's defaults, ``EmaConfig()``, as the reference and
the JAX package use).  On the card the net's forward launches the port's
kernels (K1, K2a, K2b, K3 in a fused NAFNet level, K4 in the DiT); their
backwards are the autograd of the plain compositions and, for K4, the
streamed ``flash_mha_backward``.

Draws come from the run's ``torch.Generator`` through
``sde.generate_random_states``, in sequence; the generator's state is part
of a checkpoint, so a resumed run draws what an uninterrupted one would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from .ema import EMA
from .losses import matching_loss
from .optimizers import ScheduledOptimizer


@dataclass
class TrainState:
    step: int  # train-step calls made
    net: nn.Module  # its parameters are the trained ones, updated in place
    optimizer: ScheduledOptimizer
    ema: Optional[EMA]  # None: a task that keeps no EMA (the compressor, latent bokeh)


def create_train_state(net: nn.Module, optimizer: ScheduledOptimizer, ema: bool = True) -> TrainState:
    return TrainState(step=0, net=net, optimizer=optimizer, ema=EMA(dict(net.named_parameters())) if ema else None)


def _score_net(net: nn.Module, remat: bool) -> Callable:
    """``net``, or ``net`` whose activations are recomputed in the backward
    pass (``torch.utils.checkpoint``: device memory for FLOPs)."""
    if not remat:
        return net
    return lambda *args: torch.utils.checkpoint.checkpoint(net, *args, use_reentrant=False)


def _apply_update(state: TrainState, loss: torch.Tensor) -> TrainState:
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    if state.ema is not None:
        state.ema.update(dict(state.net.named_parameters()))
    state.step += 1
    return state


def make_train_step(
    sde,
    loss_type: str = "l1",
    is_weighted: bool = False,
    weight: float = 1.0,
    remat: bool = False,
) -> Callable:
    """The IR-SDE train step, ``(state, lq, gt, gen[, cond]) -> (state,
    metrics)`` with NHWC float32 ``lq``/``gt`` on the net's device and the
    run's generator; ``state.net(x_t, lq, t)`` predicts the noise, or
    ``state.net(x_t, lq, t, cond)`` where a ``cond`` is given (the bokeh
    net's lens values).  ``remat=True`` recomputes the score net's forward
    in the backward pass."""

    def train_step(state: TrainState, lq: torch.Tensor, gt: torch.Tensor, gen: torch.Generator,
                   cond: Optional[Tuple] = None):
        timesteps, xt = sde.generate_random_states(gen, gt, lq)
        tvec = timesteps.reshape(-1)
        noise = _score_net(state.net, remat)(xt, lq, tvec, *(() if cond is None else (cond,)))
        score = sde.score_from_noise(noise, timesteps)
        pred = sde.reverse_sde_step_mean(xt, lq, score, timesteps)
        target = sde.reverse_optimum_step(xt, gt, lq, timesteps)
        w = sde.weights(tvec) if is_weighted else None
        loss = weight * matching_loss(pred, target, loss_type, w)
        return _apply_update(state, loss), {"loss": loss.detach()}

    return train_step


def make_denoising_train_step(
    sde,
    loss_type: str = "l1",
    is_weighted: bool = True,
    weight: float = 1.0,
    remat: bool = False,
) -> Callable:
    """The unconditional denoising-SDE train step, ``(state, gt, gen) ->
    (state, metrics)``: the net sees the noisy state alone,
    ``state.net(x_t, None, t)``, and the loss is sigma^2-weighted by default.
    Parity: ref config/denoising-sde/models/denoising_model.py:136-160."""

    def train_step(state: TrainState, gt: torch.Tensor, gen: torch.Generator):
        timesteps, xt = sde.generate_random_states(gen, gt)
        tvec = timesteps.reshape(-1)
        noise = _score_net(state.net, remat)(xt, None, tvec)
        score = sde.score_from_noise(noise, timesteps)
        pred = sde.reverse_sde_step_mean(xt, score, timesteps)
        target = sde.reverse_optimum_step(xt, gt, timesteps)
        w = sde.weights(tvec) if is_weighted else None
        loss = weight * matching_loss(pred, target, loss_type, w)
        return _apply_update(state, loss), {"loss": loss.detach()}

    return train_step
