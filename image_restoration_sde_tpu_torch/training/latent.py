"""Refusion latent-space restoration (PyTorch).

Counterpart of ``make_latent_sampler`` in
``image_restoration_sde_tpu/training/latent.py``: encode the LQ image with
the frozen compressor, noise the latent, reverse the IR-SDE in latent space
with the score net, decode with the LQ skips and crop to the input size; the bokeh net takes
its lens values as a per-sample ``cond``.
The compressor and latent train steps are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..models.latent_unet import UNet
from ..sampling import check_mode, make_noise_fn, reverse, run_chunks
from ..sde import IRSDE
from ..sde.rng import GeneratorLike


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
