"""Stereo ConditionalNAFNet with SCAM cross-attention (PyTorch).

Counterpart of ``image_restoration_sde_tpu/models/stereo_nafnet.py``: the
6-channel stereo input is split into left and right views, each
residual-conditioned as ``concat([x_t - cond, cond])``, and run as one
doubled batch ``[L; R]`` with the time vector repeated; every NAFBlock is
followed by a Stereo Cross Attention Module (left <-> right attention along
the width, at 1/4 scale); the two halves of the output are concatenated
back on channels.  Inputs are zero-padded at the bottom/right to a
multiple of 2^len(enc_blk_nums) and cropped back.

No level goes through the fused NAF stack (K3): a SCAM runs between any
two blocks.  Tensor parallelism: the NAFNet family's plan
(``NAFNetPyramid.tensor_parallel_plan``), which splits SCAM's four 1x1
projections by input channel with the other convolutions; SCAM's norms,
``beta`` and ``gamma`` stay whole.  ``forward`` takes and returns NHWC
float32; inside, activations are NCHW in ``channels_last`` memory in the
compute ``dtype``; parameters stay float32.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from .modules import (
    ChannelLayerNorm,
    Conv2d,
    Linear,
    SimpleGate,
    SinusoidalPosEmb,
    bicubic_resize_weights,
    check_image_size,
    nearest_indices,
)
from .nafnet import NAFBlock, NAFNetPyramid, run_blocks


@functools.lru_cache(maxsize=64)
def _resize_tables(H: int, W: int, device: torch.device):
    """SCAM's resize operators for an H x W map: the bicubic 1/4 matrices
    (rows, columns) and the nearest indices back up, made once per shape
    and device, the last 64 kept (a host-to-device copy on every call would
    wait for the card)."""
    hs, ws = max(H // 4, 1), max(W // 4, 1)
    with torch.inference_mode(False):
        return (torch.from_numpy(bicubic_resize_weights(H, hs)).to(device),
                torch.from_numpy(bicubic_resize_weights(W, ws)).to(device),
                torch.from_numpy(nearest_indices(hs, H)).to(device),
                torch.from_numpy(nearest_indices(ws, W)).to(device))


class SCAM(nn.Module):
    """Stereo Cross Attention Module on the doubled batch ``[L; R]``.

    Down to 1/4 with torch's bicubic (a = -0.75, as two float32 matmuls);
    q = 1x1(LayerNorm(x)), v = 1x1(x) per view; per-row attention over the
    width in float32, both directions from one score matrix; scaled by
    beta (right to left) and gamma (left to right), zero at init; back to
    full size with the JAX package's half-pixel nearest rule; added to each
    view."""

    def __init__(self, c: int, plain: bool = False):
        super().__init__()
        self.scale = c**-0.5
        self.norm_l = ChannelLayerNorm(c, plain=plain)
        self.norm_r = ChannelLayerNorm(c, plain=plain)
        self.l_proj1 = Conv2d(c, c, 1)
        self.r_proj1 = Conv2d(c, c, 1)
        self.l_proj2 = Conv2d(c, c, 1)
        self.r_proj2 = Conv2d(c, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B2, C, H, W = x.shape
        B = B2 // 2
        wh, ww, ih, iw = _resize_tables(H, W, x.device)
        hs, ws = wh.shape[0], ww.shape[0]
        xh = x.permute(0, 2, 3, 1)  # (2B, H, W, C)
        rows = torch.matmul(wh, xh.float().reshape(B2, H, W * C)).reshape(B2 * hs, W, C)
        small = torch.matmul(ww, rows).reshape(B2, hs, ws, C).to(x.dtype).permute(0, 3, 1, 2)
        x_ls, x_rs = small[:B], small[B:]

        def nhwc32(t):
            return t.permute(0, 2, 3, 1).float()

        q_l = nhwc32(self.l_proj1(self.norm_l(x_ls)))
        q_r = nhwc32(self.r_proj1(self.norm_r(x_rs)))
        v_l, v_r = nhwc32(self.l_proj2(x_ls)), nhwc32(self.r_proj2(x_rs))

        attn = torch.matmul(q_l, q_r.transpose(-1, -2)) * self.scale  # (B, hs, W_l, W_r)
        f_r2l = torch.matmul(torch.softmax(attn, dim=-1), v_r)
        f_l2r = torch.matmul(torch.softmax(attn, dim=-2).transpose(-1, -2), v_l)
        f_r2l = (f_r2l * self.beta.reshape(-1)).to(x.dtype)
        f_l2r = (f_l2r * self.gamma.reshape(-1)).to(x.dtype)

        def up(f):
            return f[:, ih][:, :, iw]

        out = torch.cat([xh[:B] + up(f_r2l), xh[B:] + up(f_l2r)], dim=0)
        return out.permute(0, 3, 1, 2)


class StereoNAFBlock(NAFBlock):
    """A NAFBlock whose output goes through its SCAM, ``fusion``."""

    def __init__(self, c: int, time_emb_dim: int, plain: bool = False):
        super().__init__(c, time_emb_dim, plain)
        self.fusion = SCAM(c, plain=plain)

    def forward(self, x, temb):
        return self.fusion(super().forward(x, temb))


class StereoConditionalNAFNet(NAFNetPyramid):
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
                         lambda chan: StereoNAFBlock(chan, time_dim, plain=plain))
        self.dtype = dtype
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(width), Linear(width, time_dim * 2), SimpleGate(), Linear(time_dim, time_dim)
        )

    def forward(self, inp: torch.Tensor, cond: torch.Tensor, time) -> torch.Tensor:
        """``inp`` and ``cond`` (B, H, W, 2c): left view in the first c
        channels, right in the last c."""
        B, H, W, C2 = inp.shape
        time = torch.as_tensor(time, dtype=torch.float32, device=inp.device).reshape(-1).expand(B)
        c = C2 // 2
        views = [torch.cat([inp[..., s] - cond[..., s], cond[..., s]], dim=-1)
                 for s in (slice(0, c), slice(c, C2))]
        t = self.time_mlp(torch.cat([time, time]))  # float32, as flax's dtype-less Dense

        x = check_image_size(torch.cat(views, dim=0), self.padder_size, mode="zeros")
        x = x.to(self.dtype).contiguous().permute(0, 3, 1, 2)  # channels_last NCHW
        x = self.pyramid(x, lambda blocks, x: run_blocks(blocks, x, t))
        x = x.permute(0, 2, 3, 1)[:, :H, :W, :]
        return torch.cat([x[:B], x[B:]], dim=-1).float()
