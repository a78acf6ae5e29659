"""ConditionalNAFNet score network, Refusion's backbone (PyTorch).

Counterpart of ``image_restoration_sde_tpu/models/nafnet.py``: NAFBlocks
(1x1 expand -> 3x3 depthwise -> SimpleGate -> simplified channel attention
-> 1x1, then a SimpleGate FFN; time scale/shift on both branches; learned
per-channel beta/gamma residual scales), 2x2 stride-2 downsamples,
1x1 + PixelShuffle upsamples with additive skips, and a SimpleGate time
MLP.  Inputs are zero-padded at the bottom/right to a multiple of
2^len(enc_blk_nums) and cropped back.

A run of at least ``FUSE_MIN_BLOCKS`` blocks at one level (the 28-block
deep level of the Refusion configs) at a width K3 takes (``fuses``) goes
through the fused stack (``ops/naf_stack.py``, kernel K3): all math in
float32 with float32 weights, each block's output rounded to the compute
dtype.  Other runs go block by block in the compute dtype.  The two
compute different functions in bf16, as in the JAX package; the gate
decides which one, not the device.

``forward`` takes and returns NHWC float32; inside, activations are NCHW in
``channels_last`` memory in the compute ``dtype``; parameters stay float32.
"""

from __future__ import annotations

import operator
from typing import Sequence

import torch
from torch import nn

from ..ops.naf_stack import CHANNEL_MULTIPLE, PARAM_ORDER, naf_stack, naf_stack_plain, stack_middle_params
from .modules import (
    ChannelLayerNorm,
    Conv2d,
    Linear,
    PixelShuffle,
    SimpleGate,
    SinusoidalPosEmb,
    check_image_size,
    simple_gate,
)

FUSE_MIN_BLOCKS = 4
_BLOCK_KEYS = PARAM_ORDER + ("mlp.1.weight", "mlp.1.bias")


def fuses(blocks: nn.ModuleList) -> bool:
    """Whether a level's blocks run as one fused stack: at least
    FUSE_MIN_BLOCKS of them, at a width K3 takes (a multiple of
    CHANNEL_MULTIPLE channels)."""
    return len(blocks) >= FUSE_MIN_BLOCKS and blocks[0].beta.shape[1] % CHANNEL_MULTIPLE == 0


class NAFBlockBody(nn.Module):
    """A NAFBlock without its time Dense: reference key space ``conv1`` ..
    ``conv5``, ``sca.1``, ``norm1``, ``norm2``, ``beta``, ``gamma``.  Both
    expansions are 2, as in every configuration of the reference (and K3
    takes only 2)."""

    def __init__(self, c: int, plain: bool = False):
        super().__init__()
        self.conv1 = Conv2d(c, 2 * c, 1)
        self.conv2 = Conv2d(2 * c, 2 * c, 3, padding=1, groups=2 * c)
        self.conv3 = Conv2d(c, c, 1)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv2d(c, c, 1))
        self.conv4 = Conv2d(c, 2 * c, 1)
        self.conv5 = Conv2d(c, c, 1)
        self.norm1 = ChannelLayerNorm(c, plain=plain)
        self.norm2 = ChannelLayerNorm(c, plain=plain)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def body(self, x, shift_att, scale_att, shift_ffn, scale_ffn, ffn_mod=None):
        """Both halves under the time modulation; ``ffn_mod`` = (scale,
        shift) modulates the FFN between its SimpleGate and ``conv5`` (the
        bokeh block's camera embedding)."""
        inp = x
        x = self.norm1(x) * (scale_att + 1) + shift_att
        x = simple_gate(self.conv2(self.conv1(x)))
        x = self.conv3(x * self.sca(x))
        # beta/gamma are float32 parameters multiplied in the compute dtype
        y = inp + x * self.beta.to(x.dtype)

        x = self.norm2(y) * (scale_ffn + 1) + shift_ffn
        x = simple_gate(self.conv4(x))
        if ffn_mod is not None:
            x = x * (ffn_mod[0] + 1) + ffn_mod[1]
        x = self.conv5(x)
        return y + x * self.gamma.to(x.dtype)


class NAFBlock(NAFBlockBody):
    """The body plus ``mlp.1``, the time Dense."""

    def __init__(self, c: int, time_emb_dim: int, plain: bool = False):
        super().__init__(c, plain)
        self.mlp = nn.Sequential(SimpleGate(), Linear(time_emb_dim // 2, c * 4))

    def tensors(self) -> dict:
        """The block's tensors by reference key (the ones in use, also
        under ``torch.func.functional_call``)."""
        return {k: operator.attrgetter(k)(self) for k in _BLOCK_KEYS}

    def forward(self, x, temb):
        # time modulation in the compute dtype, as the unfused flax block
        t = self.mlp(temb.to(x.dtype))[:, :, None, None]
        return self.body(x, *t.chunk(4, dim=1))  # shift_att, scale_att, shift_ffn, scale_ffn


class NAFNetPyramid(nn.Module):
    """The NAFNet's levels: a 3x3 intro conv, encoder levels each followed
    by a 2x2 stride-2 downsample, the middle blocks, 1x1 + PixelShuffle
    upsamples with additive skips before each decoder level, a 3x3 ending
    conv.  ``make_block(chan)`` builds one block; :meth:`pyramid` runs the
    levels with the caller's level runner."""

    def __init__(self, in_ch: int, out_ch: int, width: int, middle_blk_num: int,
                 enc_blk_nums: Sequence[int], dec_blk_nums: Sequence[int], make_block):
        super().__init__()
        self.padder_size = 2 ** len(enc_blk_nums)

        def level(chan, num):
            return nn.ModuleList([make_block(chan) for _ in range(num)])

        self.intro = Conv2d(in_ch, width, 3, padding=1)
        self.ending = Conv2d(width, out_ch, 3, padding=1)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(level(chan, num))
            self.downs.append(Conv2d(chan, 2 * chan, 2, 2))
            chan *= 2
        self.middle_blks = level(chan, middle_blk_num)
        for num in dec_blk_nums:
            self.ups.append(nn.Sequential(Conv2d(chan, chan * 2, 1, bias=False), PixelShuffle(2)))
            chan //= 2
            self.decoders.append(level(chan, num))

    def pyramid(self, x: torch.Tensor, run) -> torch.Tensor:
        """``x`` (NCHW, channels_last) through the levels; ``run(blocks, x)``
        runs one level's blocks."""
        x = self.intro(x)
        skips = []
        for blocks, down in zip(self.encoders, self.downs):
            x = run(blocks, x)
            skips.append(x)
            x = down(x)
        x = run(self.middle_blks, x)
        for up, blocks, skip in zip(self.ups, self.decoders, reversed(skips)):
            x = run(blocks, up(x) + skip)
        return self.ending(x)


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, *cond) -> torch.Tensor:
    """A level's blocks one by one, each called as ``blk(x, *cond)``."""
    for blk in blocks:
        x = blk(x, *cond)
    return x


class ConditionalNAFNet(NAFNetPyramid):
    def __init__(
        self,
        img_channel: int = 3,
        width: int = 16,
        middle_blk_num: int = 1,
        enc_blk_nums: Sequence[int] = (),
        dec_blk_nums: Sequence[int] = (),
        dtype: torch.dtype = torch.float32,
        plain: bool = False,
    ):
        time_dim = width * 4
        super().__init__(img_channel * 2, img_channel, width, middle_blk_num, enc_blk_nums, dec_blk_nums,
                         lambda chan: NAFBlock(chan, time_dim, plain=plain))
        self.dtype, self.plain = dtype, plain
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(width), Linear(width, time_dim * 2), SimpleGate(), Linear(time_dim, time_dim)
        )

    def _block_run(self, blocks: nn.ModuleList, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """A level's blocks: fused through the NAF stack where ``fuses``
        says so, else one by one."""
        if not fuses(blocks):
            return run_blocks(blocks, x, t)
        # float32 weights, read in place (``fused_param_names``)
        params = [blk.tensors() for blk in blocks]
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        rows = x.permute(0, 2, 3, 1)  # channels_last: contiguous (B, H, W, C)
        if self.plain:
            out = naf_stack_plain(rows, stack_middle_params(params, t), eps)
        else:
            out = naf_stack(rows, params, t, eps)
        return out.permute(0, 3, 1, 2)

    def fused_param_names(self) -> list:
        """Names of the parameters that fused levels read.  The fused math
        takes them in float32, so a caller casting the net's parameters
        (``sampling.make_noise_fn``) keeps these in float32 storage: cast
        once, not on every forward."""
        levels = [f"encoders.{j}" for j in range(len(self.encoders))] + ["middle_blks"]
        levels += [f"decoders.{j}" for j in range(len(self.decoders))]
        names = []
        for level in levels:
            blocks = self.get_submodule(level)
            if fuses(blocks):
                names += [f"{level}.{b}.{k}" for b in range(len(blocks)) for k in _BLOCK_KEYS]
        return names

    def forward(self, inp: torch.Tensor, cond: torch.Tensor, time) -> torch.Tensor:
        B, H, W, _ = inp.shape
        time = torch.as_tensor(time, dtype=torch.float32, device=inp.device).reshape(-1).expand(B)
        t = self.time_mlp(time)  # float32, as flax's dtype-less Dense

        x = torch.cat([inp - cond, cond], dim=-1)
        x = check_image_size(x, self.padder_size, mode="zeros")
        x = x.to(self.dtype).contiguous().permute(0, 3, 1, 2)  # channels_last NCHW
        x = self.pyramid(x, lambda blocks, x: self._block_run(blocks, x, t))
        return x.permute(0, 2, 3, 1)[:, :H, :W, :].float()
