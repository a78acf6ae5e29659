"""Refusion latent compressor UNet (PyTorch).

Counterpart of ``image_restoration_sde_tpu/models/latent_unet.py``:
``encode`` keeps two skip features per level plus the stem, and projects the
deepest features to an ``embed_dim``-channel latent with a 1x1 conv; the
deepest level keeps its resolution (a 3x3 conv instead of a downsample), so
the latent is at 1/2^(depth-1) of the input.  ``decode`` re-consumes the
skips and adds the stem before the final conv.  Linear attention at the
deepest level only; no time conditioning.  Inputs are reflect-padded at the
bottom/right to a multiple of 2^depth.

Images and latents are NHWC; skips are NCHW in ``channels_last`` memory.
The compressor runs in float32, as the JAX package's latent sampler keeps
it.  Reference key space: ``init_conv``, ``encoder.{i}.{0..3}``,
``decoder.{k}.{0..3}`` (k = depth-1-i: the decoder list is built deepest
first), ``latent_conv``, ``post_latent_conv``, ``final_conv``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from .modules import (
    Conv2d,
    Downsample,
    LinearAttention,
    PreNormResidual,
    ResBlock,
    Upsample,
    check_image_size,
)


class UNet(nn.Module):
    def __init__(
        self,
        in_ch: int = 3,
        out_ch: int = 3,
        ch: int = 64,
        ch_mult: Sequence[int] = (1, 2, 4, 4),
        embed_dim: int = 4,
        plain: bool = False,
    ):
        super().__init__()
        self.depth = len(ch_mult)
        mult = [1, *ch_mult]

        def attn(dim, last):
            return PreNormResidual(dim, LinearAttention(dim, plain=plain), plain=plain) if last else nn.Identity()

        self.init_conv = Conv2d(in_ch, ch, 3, padding=1, bias=False)
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for i in range(self.depth):
            dim_in, dim_out = ch * mult[i], ch * mult[i + 1]
            last = i == self.depth - 1
            self.encoder.append(nn.ModuleList([
                ResBlock(dim_in, dim_in),
                ResBlock(dim_in, dim_in),
                attn(dim_in, last),
                Conv2d(dim_in, dim_out, 3, padding=1, bias=False) if last else Downsample(dim_in, dim_out),
            ]))
            self.decoder.insert(0, nn.ModuleList([
                ResBlock(dim_out + dim_in, dim_out),
                ResBlock(dim_out + dim_in, dim_out),
                attn(dim_out, last),
                Conv2d(dim_out, dim_in, 3, padding=1, bias=False) if i == 0 else Upsample(dim_out, dim_in),
            ]))
        mid_dim = ch * mult[-1]
        self.latent_conv = Conv2d(mid_dim, embed_dim, 1, bias=False)
        self.post_latent_conv = Conv2d(embed_dim, mid_dim, 1, bias=False)
        self.final_conv = Conv2d(ch, out_ch, 3, padding=1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """NHWC image -> (NHWC latent, skips)."""
        x = check_image_size(x, 2**self.depth, mode="reflect")
        x = self.init_conv(x.float().contiguous().permute(0, 3, 1, 2))
        hs = [x]
        for block1, block2, attn, down in self.encoder:
            x = block1(x)
            hs.append(x)
            x = attn(block2(x))
            hs.append(x)
            x = down(x)
        return self.latent_conv(x).permute(0, 2, 3, 1), hs

    def decode(self, latent: torch.Tensor, hs: List[torch.Tensor],
               hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """NHWC latent and the skips -> NHWC float32 image, cropped to ``hw``
        when given."""
        x = self.post_latent_conv(latent.float().contiguous().permute(0, 3, 1, 2))
        for k, (block1, block2, attn, up) in enumerate(self.decoder):  # deepest first
            x = block1(torch.cat([x, hs[-(2 * k + 1)]], dim=1))
            x = block2(torch.cat([x, hs[-(2 * k + 2)]], dim=1))
            x = up(attn(x))
        x = self.final_conv(x + hs[0]).permute(0, 2, 3, 1)
        if hw is not None:
            x = x[:, : hw[0], : hw[1], :]
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        latent, hs = self.encode(x)
        return self.decode(latent, hs, x.shape[1:3])
