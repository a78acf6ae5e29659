"""Refusion latent-space training and restoration (PyTorch).

Counterpart of ``image_restoration_sde_tpu/training/latent.py``:

- :func:`make_compressor_train_step`: the compressor's cross-reconstruction
  objective (ref unet-latent latent_model.py:141-170),
  ``loss_rec = ||dec(enc(LQ).lat, skips_LQ) - LQ||``,
  ``loss_rep = ||dec(enc(GT).lat, skips_LQ) - GT||`` (the GT latent decoded
  with the LQ skips: the latent carries the restoration signal),
  ``loss_reg = |mean(L_lq) - mean(LQ)| + |std(L_lq) - 0.5 std(LQ)|`` with
  population standard deviations, total ``rec + rep + 0.001 reg``.  The
  JAX step also updates an EMA that its task never saves and the reference
  has none of; the port keeps none.
- :func:`make_latent_train_step`: the latent dehazing / bokeh objective
  (ref latent_denoising_model.py:154-176): LQ and GT encoded by the FROZEN
  compressor in one 2B batch, then the pixel IR-SDE step on the latents.
  On the card the encode runs inside the step's captured graph
  (``training/captured.py``), as it runs inside the JAX latent step's jit.
- :func:`make_latent_sampler`: encode the LQ image with the frozen
  compressor, noise the latent, reverse the IR-SDE in latent space with the
  score net, decode with the LQ skips and crop to the input size; the bokeh
  net takes its lens values as a per-sample ``cond``.  On the card encode,
  chain and decode are one captured graph a signature, as the JAX
  package's sampler is one jitted program.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..models.latent_unet import UNet
from .. import kernels
from ..sampling import CapturedNet, capture_graphs, captures, check_mode, chunked, make_noise_fn, reverse, run_chunks
from ..sde import IRSDE, samplers
from ..sde.captured import generator_layout
from ..sde.rng import GeneratorLike
from .captured import replays, step_graphs
from .losses import matching_loss
from .trainer import TrainState, eager_step, irsde_loss, replayed_step


def make_compressor_train_step(loss_type: str = "l1", weight: float = 1.0, reg_weight: float = 0.001,
                               capture=True) -> Callable:
    """The compressor's train step, ``(state, lq, gt, gen) -> (state,
    metrics)``: ``state.net`` is the compressor :class:`UNet`, ``lq`` and
    ``gt`` NHWC float32 at a multiple of its padding (``gen`` is not drawn
    from: the objective has no noise).  Metrics: ``loss``, ``loss_rec``,
    ``loss_rep``, ``loss_reg``.  ``capture`` as in
    ``trainer.make_train_step``."""
    graphs = step_graphs(capture)

    def loss(state, lq, gt):
        rec, rep, l_lq = (state.ddp if state.ddp is not None else CrossDecode(state.net))(lq, gt)
        loss_rec = matching_loss(rec, lq, loss_type)
        loss_rep = matching_loss(rep, gt, loss_type)
        loss_reg = ((l_lq.mean() - lq.mean()).abs()
                    + (l_lq.std(correction=0) - lq.std(correction=0) * 0.5).abs())
        total = weight * (loss_rec + loss_rep + reg_weight * loss_reg)
        return {"loss": total, "loss_rec": loss_rec, "loss_rep": loss_rep, "loss_reg": loss_reg}

    def train_step(state: TrainState, lq: torch.Tensor, gt: torch.Tensor, gen=None):
        if not replays(graphs, state, lq):
            return eager_step(state, loss(state, lq, gt))
        return replayed_step(state, graphs, ("compressor",), lambda lq, gt: loss(state, lq, gt), (lq, gt))

    train_step.graphs = graphs
    return train_step


class CrossDecode(nn.Module):
    """The compressor's forward in its train step, ``(lq, gt) -> (LQ
    reconstructed, GT's latent decoded with the LQ's skips, LQ's latent)``:
    one module call, so DDP sees the step's forward (``data_parallel``).
    Under data parallelism ``loss_reg``'s mean and std are each rank's own
    rows', as in the reference's DDP."""

    def __init__(self, compressor: UNet):
        super().__init__()
        self.compressor = compressor

    def forward(self, lq: torch.Tensor, gt: torch.Tensor):
        l_lq, h_lq = self.compressor.encode(lq)
        l_gt, _ = self.compressor.encode(gt)
        return self.compressor.decode(l_lq, h_lq), self.compressor.decode(l_gt, h_lq), l_lq


def make_latent_train_step(sde: IRSDE, compressor: UNet, loss_type: str = "l1", is_weighted: bool = False,
                           weight: float = 1.0, remat: bool = False, capture=True) -> Callable:
    """The latent IR-SDE train step, ``(state, lq, gt, gen[, cond]) ->
    (state, metrics)``: ``compressor`` (frozen here: no grad, eval mode)
    encodes the concatenated LQ and GT batch under ``torch.no_grad()``, and
    ``trainer.make_train_step``'s objective runs on the two latents, its
    states drawn from ``gen``; ``cond`` (the bokeh lens values) goes to the
    score net as its fourth argument.  The EMA moves where the state keeps
    one.  ``remat`` wraps the score net in ``torch.utils.checkpoint`` (the
    JAX runners never pass it to their latent tasks).  ``capture`` as in
    ``make_train_step``: a replayed step encodes inside its graph, its
    draws shaped by ``compressor.latent_shape``."""
    compressor.requires_grad_(False).eval()
    kw = dict(loss_type=loss_type, is_weighted=is_weighted, weight=weight, remat=remat)
    graphs = step_graphs(capture)

    def latents(lq, gt):
        with torch.no_grad():
            latent, _ = compressor.encode(torch.cat([lq, gt], dim=0))
        return latent.chunk(2, dim=0)

    def train_step(state: TrainState, lq: torch.Tensor, gt: torch.Tensor, gen: torch.Generator,
                   cond: Optional[Tuple] = None):
        if not replays(graphs, state, lq):
            latent_lq, latent_gt = latents(lq, gt)
            states = sde.generate_random_states(gen, latent_gt, latent_lq, state.shard)
            return eager_step(state, irsde_loss(sde, state, latent_lq, latent_gt, states, cond, **kw))

        def loss_fn(lq, gt, timesteps, noises, *cond):
            latent_lq, latent_gt = latents(lq, gt)
            states = sde.compose_states(latent_gt, latent_lq, timesteps, noises)
            return irsde_loss(sde, state, latent_lq, latent_gt, states, cond or None, **kw)

        draws = sde.draw_states(gen, lq.new_empty(compressor.latent_shape(lq.shape)), state.shard)
        return replayed_step(state, graphs, ("latent", remat), loss_fn, (lq, gt, *draws, *(cond or ())),
                             also=(compressor,))

    train_step.graphs = graphs
    return train_step


def make_latent_sampler(
    sde: IRSDE,
    net: nn.Module,  # net(xt, cond, tvec[, lens]) -> noise, on NHWC latents
    compressor: UNet,
    mode: str = "sde",
    steps: Optional[int] = None,
    chunk: Optional[int] = None,
    cast_params=None,
    capture=True,
) -> Callable:
    """Returns ``sample(lq, gen, cond=None) -> restored`` (NHWC float32,
    lq's shape).

    ``gen``, ``chunk``, ``mode`` and ``capture`` as in
    ``sampling.make_restoration_sampler``: one generator draws the initial
    latent noise and then the chain's.  ``cond``, a tuple of per-sample
    tensors (the bokeh net's lens values, each (B,)), goes to the net as
    its fourth argument at every step and is sliced with the batch when
    the batch runs in chunks; a captured chain takes it as a static input.
    ``cast_params`` applies to the score net, which runs every step; the
    one-shot compressor keeps its parameters.  On the card encode, chain
    and decode are captured as one graph a signature (the latent's shape,
    which the noise buffer takes, found once a shape by an encode counted
    with the warm-up); ``sample.prepare(lq, gen, cond=None)`` captures
    without drawing."""
    check_mode(mode)
    T = sde.T if steps is None else steps
    graphs = capture_graphs(capture)
    captured = None if graphs is None else CapturedNet(net, cast_params, graphs, also=(compressor,))
    latent_shapes = {}

    def chain(n):
        def run(x, noise, *c):
            fn = captured.fn()
            noise_fn = fn if not c else (lambda xt, mu, tvec: fn(xt, mu, tvec, c))
            latent_lq, hidden = compressor.encode(x)
            draws = noise[: samplers.chain_draws(mode, n)]
            latent = samplers.reverse_from_noise(sde, noise_fn, latent_lq, draws, mode, n)
            return compressor.decode(latent, hidden)[:, : x.shape[1], : x.shape[2], :]

        return run

    def latent_shape(x):
        if x.shape not in latent_shapes:
            with kernels.warming_up():
                latent_shapes[x.shape] = tuple(compressor.encode(x)[0].shape)
        return latent_shapes[x.shape]

    def replay(x, g, c=None, draw=True):
        key = (tuple(x.shape), x.dtype, mode, T, generator_layout(g), chunk, c is not None)
        like = x.new_empty(latent_shape(x))
        n = samplers.chain_draws(mode, T)
        inputs = (x, samplers.draw_noise(g, like, n) if draw else x.new_zeros((n, *like.shape)), *(c or ()))
        if not draw:
            return graphs.prepare(key, chain(T), inputs, warmup=chain(1))
        return graphs(key, chain(T), inputs, warmup=chain(1))

    @torch.inference_mode()
    def sample(lq: torch.Tensor, gen: GeneratorLike, cond: Optional[Tuple] = None) -> torch.Tensor:
        if captures(graphs, lq):
            captured.sync()
            return run_chunks(replay, lq, gen, chunk, cond)
        net_fn = make_noise_fn(net, cast_params)

        def sample_one(x, g, c=None):
            noise_fn = net_fn if c is None else (lambda xt, mu, tvec: net_fn(xt, mu, tvec, c))
            latent_lq, hidden = compressor.encode(x)
            noisy = sde.noise_state(g, latent_lq)
            latent = reverse(sde, noise_fn, noisy, latent_lq, g, mode, steps)
            return compressor.decode(latent, hidden)[:, : x.shape[1], : x.shape[2], :]

        return run_chunks(sample_one, lq, gen, chunk, cond)

    @torch.inference_mode()
    def prepare(lq: torch.Tensor, gen: GeneratorLike, cond: Optional[Tuple] = None) -> None:
        if not captures(graphs, lq):
            return
        captured.sync()
        for args in chunked(lq, gen, chunk, cond):
            replay(*args, draw=False)

    sample.graphs, sample.prepare = graphs, prepare
    return sample
