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

On the card, in one process, a step replays one captured CUDA graph of its
forward, backward and update a step signature (``training/captured.py``),
as the JAX package jits its step: the draws come from the same generator
in the same order (``sde.draw_states``) into the graph's inputs, which
composes them (``sde.compose_states``), so a replayed step is the eager
step bit for bit and leaves the generator where it does.  The CPU,
data- and tensor-parallel steps and a step maker given ``capture=False``
run eagerly.

Data parallelism (:func:`data_parallel`): the step's forward runs through a
``DistributedDataParallel`` wrapper of the net, which averages the
gradients over the ranks; every rank draws the global batch's timesteps and
noise and keeps its own rows (``state.shard``), so N ranks take the
one-process step at the global batch, and the loss they report is the
global batch's (the ranks' mean).  The optimizer, the EMA and checkpoints
read the bare net's parameters.

Tensor parallelism (:func:`tensor_parallel`): the net is split over the
model group of a mesh (``parallel/tensor.py``), and the optimizer and the
EMA hold this rank's shards; DDP then runs over the data group alone
(the ranks holding the same shard), and ``state.shard`` is the data axis's
(rank, size), so the ranks of a model group draw and keep the same rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from ..parallel import dist
from ..parallel.tensor import parallelize
from .captured import replays, step_graphs
from .ema import EMA
from .losses import matching_loss
from .optimizers import ScheduledOptimizer


@dataclass
class TrainState:
    step: int  # train-step calls made
    net: nn.Module  # its parameters are the trained ones, updated in place
    optimizer: ScheduledOptimizer
    ema: Optional[EMA]  # None: a task that keeps no EMA (the compressor, latent bokeh)
    # data parallelism (data_parallel): the DDP wrapper the step's forward
    # runs through, and (data rank, data size), whose rows of the global
    # draws the step keeps; None in one process
    ddp: Optional[nn.Module] = None
    shard: Optional[tuple] = None
    # tensor parallelism (tensor_parallel): the layout of the split net's
    # parameters (parallel.tensor.Layout); None: the net is whole
    layout: Optional[object] = None


def create_train_state(net: nn.Module, optimizer: ScheduledOptimizer, ema: bool = True) -> TrainState:
    return TrainState(step=0, net=net, optimizer=optimizer, ema=EMA(dict(net.named_parameters())) if ema else None)


class Remat(nn.Module):
    """``net`` whose activations are recomputed in the backward pass
    (``torch.utils.checkpoint``: device memory for FLOPs)."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, *args):
        # the nets draw nothing in their forward, so the recompute needs no
        # saved generator state (which a graph capture cannot read)
        return torch.utils.checkpoint.checkpoint(self.net, *args, use_reentrant=False, preserve_rng_state=False)


def data_parallel(state: TrainState, module: Optional[nn.Module] = None) -> TrainState:
    """Run ``state``'s steps data-parallel over the process group
    (``parallel.dist.init``): the module the step calls (``state.net`` by
    default; :class:`Remat` of it where the step recomputes, the
    compressor's :class:`~.latent.CrossDecode`) wrapped in DDP.  DDP
    broadcasts the group's first rank's parameters once; ``static_graph``:
    every step uses the same parameters, which DDP learns at the first
    step, so a parameter that no step uses (none gets a gradient) needs no
    search of the graph each step, and a recomputed forward reduces each
    gradient once.  The nets hold no buffers, so DDP broadcasts none in a
    forward.  Under tensor parallelism DDP runs over the data group (the
    ranks that hold the same shard), and not at all where that group is
    this rank alone."""
    from torch.nn.parallel import DistributedDataParallel

    state.shard = dist.shard()
    mesh = None if state.layout is None else state.layout.mesh
    if mesh is not None and mesh.data_size == 1:
        return state
    module = state.net if module is None else module
    device = next(state.net.parameters()).device
    state.ddp = DistributedDataParallel(module, device_ids=[device] if device.type == "cuda" else None,
                                        static_graph=True, process_group=None if mesh is None else mesh.data_group)
    return state


def tensor_parallel(state: TrainState, mesh) -> TrainState:
    """Split ``state.net`` in place over ``mesh``'s model group by its plan
    (``parallel.tensor.parallelize``; a net without one raises), then build
    the optimizer (its class, settings, schedule and accumulation) and the
    EMA anew on this rank's shards.  Call it on a fresh state, before
    :func:`data_parallel`; a checkpoint then loads through ``state.layout``
    (``training.checkpoint``)."""
    opt = state.optimizer
    if state.step or opt.updates or opt.mini_step or opt.inner.state:
        raise ValueError("tensor_parallel: the train state has stepped; split a fresh one")
    state.layout = parallelize(state.net, mesh)
    inner = type(opt.inner)(list(state.net.parameters()), **opt.inner.defaults)
    state.optimizer = ScheduledOptimizer(inner, opt.schedule, opt.every_k)
    if state.ema is not None:
        state.ema = EMA(dict(state.net.named_parameters()))
    state.shard = dist.shard()
    return state


def _score_net(state: TrainState, remat: bool) -> Callable:
    """The module the step's forward runs: the DDP wrapper under data
    parallelism (of :class:`Remat` where the step recomputes), else the
    net, recomputed in the backward pass where ``remat``."""
    if state.ddp is not None:
        return state.ddp
    if not remat:
        return state.net
    return Remat(state.net)


def _apply_update(state: TrainState, loss: torch.Tensor) -> TrainState:
    state.optimizer.zero_grad()
    loss.backward()
    if state.layout is not None:  # the whole parameters' replicas step on one gradient
        state.layout.average_replicated_grads(state.net)
    state.optimizer.step()
    return _after_update(state)


def _after_update(state: TrainState) -> TrainState:
    """What follows the update on the host: the EMA and the step count."""
    if state.ema is not None:
        state.ema.update(dict(state.net.named_parameters()))
    state.step += 1
    return state


def step_metrics(state: TrainState, metrics: dict) -> dict:
    """The step's metrics, detached; under data parallelism the global
    batch's (each the ranks' mean)."""
    mean = dist.mean if state.ddp is not None else (lambda v: v)
    return {k: mean(v.detach()) for k, v in metrics.items()}


def eager_step(state: TrainState, metrics: dict):
    """``(state, metrics)`` after the backward of ``metrics["loss"]``, the
    update, the EMA and the step count, run eagerly."""
    return _apply_update(state, metrics["loss"]), step_metrics(state, metrics)


def replayed_step(state: TrainState, graphs, key, loss_fn: Callable, inputs, also=()):
    """``(state, metrics)`` of the step ``loss_fn(*inputs)`` replayed from
    ``graphs`` (``captured.StepGraphs.step``), then the EMA and the step
    count."""
    metrics = graphs.step(state, key, loss_fn, inputs, also)
    return _after_update(state), metrics


def irsde_loss(sde, state: TrainState, lq, gt, states, cond=None, loss_type: str = "l1", is_weighted: bool = False,
               weight: float = 1.0, remat: bool = False) -> dict:
    """``{"loss": ...}`` of the IR-SDE objective on ``states = (timesteps,
    x_t)`` (``lq`` the mean, ``gt`` x_0)."""
    timesteps, xt = states
    tvec = timesteps.reshape(-1)
    noise = _score_net(state, remat)(xt, lq, tvec, *(() if cond is None else (cond,)))
    score = sde.score_from_noise(noise, timesteps)
    pred = sde.reverse_sde_step_mean(xt, lq, score, timesteps)
    target = sde.reverse_optimum_step(xt, gt, lq, timesteps)
    w = sde.weights(tvec) if is_weighted else None
    return {"loss": weight * matching_loss(pred, target, loss_type, w)}


def make_train_step(
    sde,
    loss_type: str = "l1",
    is_weighted: bool = False,
    weight: float = 1.0,
    remat: bool = False,
    capture=True,
) -> Callable:
    """The IR-SDE train step, ``(state, lq, gt, gen[, cond]) -> (state,
    metrics)`` with NHWC float32 ``lq``/``gt`` on the net's device and the
    run's generator; ``state.net(x_t, lq, t)`` predicts the noise, or
    ``state.net(x_t, lq, t, cond)`` where a ``cond`` is given (the bokeh
    net's lens values).  ``remat=True`` recomputes the score net's forward
    in the backward pass.  ``capture`` (``captured.step_graphs``): on the
    card each step signature is one graph, ``train_step.graphs``."""
    kw = dict(loss_type=loss_type, is_weighted=is_weighted, weight=weight, remat=remat)
    graphs = step_graphs(capture)

    def train_step(state: TrainState, lq: torch.Tensor, gt: torch.Tensor, gen: torch.Generator,
                   cond: Optional[Tuple] = None):
        if not replays(graphs, state, lq):
            states = sde.generate_random_states(gen, gt, lq, state.shard)
            return eager_step(state, irsde_loss(sde, state, lq, gt, states, cond, **kw))

        def loss_fn(lq, gt, timesteps, noises, *cond):
            return irsde_loss(sde, state, lq, gt, sde.compose_states(gt, lq, timesteps, noises), cond or None, **kw)

        draws = sde.draw_states(gen, gt, state.shard)
        return replayed_step(state, graphs, ("irsde", remat), loss_fn, (lq, gt, *draws, *(cond or ())))

    train_step.graphs = graphs
    return train_step


def make_denoising_train_step(
    sde,
    loss_type: str = "l1",
    is_weighted: bool = True,
    weight: float = 1.0,
    remat: bool = False,
    capture=True,
) -> Callable:
    """The unconditional denoising-SDE train step, ``(state, gt, gen) ->
    (state, metrics)``: the net sees the noisy state alone,
    ``state.net(x_t, None, t)``, and the loss is sigma^2-weighted by default.
    ``capture`` as in :func:`make_train_step`.
    Parity: ref config/denoising-sde/models/denoising_model.py:136-160."""
    graphs = step_graphs(capture)

    def loss(state, gt, states):
        timesteps, xt = states
        tvec = timesteps.reshape(-1)
        noise = _score_net(state, remat)(xt, None, tvec)
        score = sde.score_from_noise(noise, timesteps)
        pred = sde.reverse_sde_step_mean(xt, score, timesteps)
        target = sde.reverse_optimum_step(xt, gt, timesteps)
        w = sde.weights(tvec) if is_weighted else None
        return {"loss": weight * matching_loss(pred, target, loss_type, w)}

    def train_step(state: TrainState, gt: torch.Tensor, gen: torch.Generator):
        if not replays(graphs, state, gt):
            return eager_step(state, loss(state, gt, sde.generate_random_states(gen, gt, state.shard)))
        draws = sde.draw_states(gen, gt, state.shard)
        return replayed_step(state, graphs, ("denoising", remat),
                             lambda gt, *d: loss(state, gt, sde.compose_states(gt, *d)), (gt, *draws))

    train_step.graphs = graphs
    return train_step
