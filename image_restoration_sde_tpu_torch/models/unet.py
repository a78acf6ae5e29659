"""ConditionalUNet score network (PyTorch).

Counterpart of ``image_restoration_sde_tpu/models/unet.py``.  The input is
``concat([x_t - cond, cond])`` (``conditional=False``, the denoising-SDE
variant: ``x_t`` alone, ``forward(x, None, t)``); a sinusoidal time
embedding feeds a float32 two-layer MLP; ``depth`` levels of two ResBlocks
and a linear attention, with a stride-2 downsample (the deepest level keeps
its resolution through a plain 3x3 conv); a middle block with linear
attention (unconditional: full spatial attention); on the way up, two skips
concatenated per level; a final ResBlock over the stem features.  Inputs are
reflect-padded at the bottom/right to a multiple of 2^depth and cropped back.

``forward`` takes and returns NHWC float32, like the flax module.  Inside,
activations are NCHW in ``channels_last`` memory in the compute ``dtype``;
parameters stay float32.  ``random_or_learned_sinusoidal_cond`` replaces
the sinusoidal time embedding by learned (or, with
``random_fourier_features``, frozen random) Fourier features of
``learned_sinusoidal_dim`` frequencies, the time MLP's input then
``learned_sinusoidal_dim + 1`` wide.

Tensor parallelism (:meth:`ConditionalUNet.tensor_parallel_plan`;
``parallel/tensor.py``): the time MLP column then row, each ResBlock's
scale/shift MLP by column inside each half and gathered, and every
convolution at least 64 channels wide at its input (``row_convs``) by input
channel (the partial convolutions all-reduced).  Activations stay whole
between those layers, so the channel LayerNorms (K1) and the packed linear
attention (K2, four heads) run at full width on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.tensor import COLUMN, ROW, Split, row_convs
from .modules import (
    Attention,
    Conv2d,
    Downsample,
    Linear,
    LinearAttention,
    PreNormResidual,
    RandomOrLearnedSinusoidalPosEmb,
    ResBlock,
    SinusoidalPosEmb,
    Upsample,
    check_image_size,
)

class ConditionalUNet(nn.Module):
    def __init__(
        self,
        in_nc: int = 3,
        out_nc: int = 3,
        nf: int = 64,
        depth: int = 4,
        conditional: bool = True,
        random_or_learned_sinusoidal_cond: bool = False,
        learned_sinusoidal_dim: int = 16,
        random_fourier_features: bool = False,
        dtype: torch.dtype = torch.float32,
        plain: bool = False,
    ):
        super().__init__()
        self.depth, self.conditional = depth, conditional
        self.dtype = dtype
        time_dim = nf * 4

        def attn(dim):
            return PreNormResidual(dim, LinearAttention(dim, plain=plain), plain=plain)

        self.init_conv = Conv2d(in_nc * 2 if conditional else in_nc, nf, 7, padding=3, bias=False)
        if random_or_learned_sinusoidal_cond:
            pos_emb, fourier_dim = (RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim, random_fourier_features),
                                    learned_sinusoidal_dim + 1)
        else:
            pos_emb, fourier_dim = SinusoidalPosEmb(nf), nf
        self.time_mlp = nn.Sequential(pos_emb, Linear(fourier_dim, time_dim), nn.GELU(), Linear(time_dim, time_dim))

        self.downs = nn.ModuleList()
        self.ups = nn.ModuleList()
        for i in range(depth):
            dim_in, dim_out = nf * 2**i, nf * 2 ** (i + 1)
            last = i == depth - 1
            self.downs.append(nn.ModuleList([
                ResBlock(dim_in, dim_in, time_dim),
                ResBlock(dim_in, dim_in, time_dim),
                attn(dim_in),
                Conv2d(dim_in, dim_out, 3, padding=1, bias=False) if last else Downsample(dim_in, dim_out),
            ]))
            # ups[0] is the deepest level
            self.ups.insert(0, nn.ModuleList([
                ResBlock(dim_out + dim_in, dim_out, time_dim),
                ResBlock(dim_out + dim_in, dim_out, time_dim),
                attn(dim_out),
                Conv2d(dim_out, dim_in, 3, padding=1, bias=False) if i == 0 else Upsample(dim_out, dim_in),
            ]))

        mid_dim = nf * 2**depth
        self.mid_block1 = ResBlock(mid_dim, mid_dim, time_dim)
        self.mid_attn = (attn(mid_dim) if conditional
                         else PreNormResidual(mid_dim, Attention(mid_dim), plain=plain))
        self.mid_block2 = ResBlock(mid_dim, mid_dim, time_dim)

        self.final_res_block = ResBlock(nf * 2, nf, time_dim)
        self.final_conv = Conv2d(nf, out_nc, 3, padding=1)

    def forward(self, xt: torch.Tensor, cond: Optional[torch.Tensor], time) -> torch.Tensor:
        B, H, W, _ = xt.shape
        time = torch.as_tensor(time, dtype=torch.float32, device=xt.device).reshape(-1).expand(B)

        x = torch.cat([xt - cond, cond], dim=-1) if self.conditional else xt
        x = check_image_size(x, 2**self.depth)
        # NHWC contiguous, seen as NCHW: channels_last memory
        x = x.to(self.dtype).contiguous().permute(0, 3, 1, 2)

        x = self.init_conv(x)
        stem = x
        t = self.time_mlp(time)  # float32, as flax's dtype-less Dense

        skips = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t)
            skips.append(x)
            x = block2(x, t)
            x = attn(x)
            skips.append(x)
            x = down(x)

        x = self.mid_block1(x, t)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t)

        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, skips.pop()], dim=1), t)
            x = block2(torch.cat([x, skips.pop()], dim=1), t)
            x = attn(x)
            x = up(x)

        x = self.final_res_block(torch.cat([x, stem], dim=1), t)
        x = self.final_conv(x)
        return x.permute(0, 2, 3, 1)[:, :H, :W, :].float()

    def tensor_parallel_plan(self, size: int) -> dict:
        """The splits over ``size`` model ranks (module name -> ``Split``);
        the Fourier features' ``weights`` stay whole."""
        plan = {"time_mlp.1": Split(COLUMN), "time_mlp.3": Split(ROW), **row_convs(self, size)}
        for name, m in self.named_modules():
            if isinstance(m, ResBlock) and m.mlp is not None:
                plan[f"{name}.mlp.1"] = Split(COLUMN, 2, gather=True)  # scale half, shift half
        return plan


def init_params_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` for the benches, the dry run and
    the kernel checks: every kernel, NAFBlock ``beta``/``gamma`` and
    Fourier ``weights`` a plain (untruncated) normal of variance 1/fan_in,
    biases 0, norm gains 1.  Not the train initialisation (a net as built,
    ``modules.lecun_normal_`` and flax's constants): it also draws the
    tensors that start at zero there (the DiT's modulations and final
    linear map, the NAFBlock scales), on purpose, so that every kernel of
    a net sees signal in its forward and its gradients."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(".g"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                fan_in = p[0].numel()
                w = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=generator.device)
                p.copy_(w * fan_in**-0.5)
    return net
