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
- :func:`make_latent_sampler`: encode the LQ image with the frozen
  compressor, noise the latent, reverse the IR-SDE in latent space with the
  score net, decode with the LQ skips and crop to the input size; the bokeh
  net takes its lens values as a per-sample ``cond``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..models.latent_unet import UNet
from ..sampling import check_mode, make_noise_fn, reverse, run_chunks
from ..sde import IRSDE
from ..sde.rng import GeneratorLike
from .losses import matching_loss
from .trainer import TrainState, _apply_update, make_train_step, step_metrics


def make_compressor_train_step(loss_type: str = "l1", weight: float = 1.0, reg_weight: float = 0.001) -> Callable:
    """The compressor's train step, ``(state, lq, gt, gen) -> (state,
    metrics)``: ``state.net`` is the compressor :class:`UNet`, ``lq`` and
    ``gt`` NHWC float32 at a multiple of its padding (``gen`` is not drawn
    from: the objective has no noise).  Metrics: ``loss``, ``loss_rec``,
    ``loss_rep``, ``loss_reg``."""

    def train_step(state: TrainState, lq: torch.Tensor, gt: torch.Tensor, gen=None):
        rec, rep, l_lq = (state.ddp if state.ddp is not None else CrossDecode(state.net))(lq, gt)
        loss_rec = matching_loss(rec, lq, loss_type)
        loss_rep = matching_loss(rep, gt, loss_type)
        loss_reg = ((l_lq.mean() - lq.mean()).abs()
                    + (l_lq.std(correction=0) - lq.std(correction=0) * 0.5).abs())
        loss = weight * (loss_rec + loss_rep + reg_weight * loss_reg)
        metrics = {"loss": loss, "loss_rec": loss_rec, "loss_rep": loss_rep, "loss_reg": loss_reg}
        return _apply_update(state, loss), step_metrics(state, metrics)

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
                           weight: float = 1.0, remat: bool = False) -> Callable:
    """The latent IR-SDE train step, ``(state, lq, gt, gen[, cond]) ->
    (state, metrics)``: ``compressor`` (frozen here: no grad, eval mode)
    encodes the concatenated LQ and GT batch under ``torch.no_grad()``, and
    :func:`~.trainer.make_train_step`'s step runs on the two latents, its
    states drawn from ``gen``; ``cond`` (the bokeh lens values) goes to the
    score net as its fourth argument.  The EMA moves where the state keeps
    one.  ``remat`` wraps the score net in ``torch.utils.checkpoint`` (the
    JAX runners never pass it to their latent tasks)."""
    compressor.requires_grad_(False).eval()
    step = make_train_step(sde, loss_type=loss_type, is_weighted=is_weighted, weight=weight, remat=remat)

    def train_step(state: TrainState, lq: torch.Tensor, gt: torch.Tensor, gen: torch.Generator,
                   cond: Optional[Tuple] = None):
        with torch.no_grad():
            latent, _ = compressor.encode(torch.cat([lq, gt], dim=0))
        latent_lq, latent_gt = latent.chunk(2, dim=0)
        return step(state, latent_lq, latent_gt, gen, cond)

    return train_step


def make_latent_sampler(
    sde: IRSDE,
    net: nn.Module,  # net(xt, cond, tvec[, lens]) -> noise, on NHWC latents
    compressor: UNet,
    mode: str = "sde",
    steps: Optional[int] = None,
    chunk: Optional[int] = None,
    cast_params=None,
) -> Callable:
    """Returns ``sample(lq, gen, cond=None) -> restored`` (NHWC float32,
    lq's shape).

    ``gen``, ``chunk`` and ``mode`` as in
    ``sampling.make_restoration_sampler``: one generator draws the initial
    latent noise and then the chain's.  ``cond``, a tuple of per-sample
    tensors (the bokeh net's lens values, each (B,)), goes to the net as
    its fourth argument at every step and is sliced with the batch when
    the batch runs in chunks.  ``cast_params`` applies to the score net,
    which runs every step; the one-shot compressor keeps its parameters."""
    check_mode(mode)

    @torch.inference_mode()
    def sample(lq: torch.Tensor, gen: GeneratorLike, cond: Optional[Tuple] = None) -> torch.Tensor:
        net_fn = make_noise_fn(net, cast_params)

        def sample_one(x, g, c=None):
            noise_fn = net_fn if c is None else (lambda xt, mu, tvec: net_fn(xt, mu, tvec, c))
            latent_lq, hidden = compressor.encode(x)
            noisy = sde.noise_state(g, latent_lq)
            latent = reverse(sde, noise_fn, noisy, latent_lq, g, mode, steps)
            return compressor.decode(latent, hidden)[:, : x.shape[1], : x.shape[2], :]

        return run_chunks(sample_one, lq, gen, chunk, cond)

    return sample
