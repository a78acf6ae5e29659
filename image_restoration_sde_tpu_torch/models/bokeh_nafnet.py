"""Bokeh ConditionalNAFNet: lens-metadata conditioning (PyTorch).

Counterpart of ``image_restoration_sde_tpu/models/bokeh_nafnet.py``: the
source and target lens values and the disparity are each sinusoidally
embedded and concatenated through a SimpleGate ``cam_mlp``; every block
scales and shifts its FFN between the SimpleGate and ``conv5`` by the
camera embedding.  The net's time and camera MLPs compute in float32, each
block's ``time_mlp`` and ``cam_mlp`` Dense in the compute dtype.

No level goes through the fused NAF stack (K3), which has no camera
modulation.  ``forward(inp, cond, time, lens_info)`` takes and returns NHWC
float32, ``lens_info`` = (src, tgt, disparity), each of shape (B,) or a
scalar.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .modules import Linear, SimpleGate, check_image_size, sinusoidal_pos_emb
from .nafnet import NAFBlockBody, NAFNetPyramid, run_blocks

LENS_VALUES = 3  # src, tgt, disparity


class BokehNAFBlock(NAFBlockBody):
    """The NAFBlock body with ``time_mlp.1`` (4c: time scale/shift of both
    halves) and ``cam_mlp.1`` (2c: the FFN's camera scale/shift)."""

    def __init__(self, c: int, time_emb_dim: int, plain: bool = False):
        super().__init__(c, plain)
        self.time_mlp = nn.Sequential(SimpleGate(), Linear(time_emb_dim // 2, c * 4))
        self.cam_mlp = nn.Sequential(SimpleGate(), Linear(time_emb_dim // 2, c * 2))

    def forward(self, x, temb, camemb):
        t = self.time_mlp(temb.to(x.dtype))[:, :, None, None]
        cam = self.cam_mlp(camemb.to(x.dtype))[:, :, None, None]
        return self.body(x, *t.chunk(4, dim=1), ffn_mod=cam.chunk(2, dim=1))  # cam: scale, shift


class BokehConditionalNAFNet(NAFNetPyramid):
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
                         lambda chan: BokehNAFBlock(chan, time_dim, plain=plain))
        self.width, self.dtype = width, dtype
        self.time_mlp = nn.Sequential(Linear(width, time_dim * 2), SimpleGate(), Linear(time_dim, time_dim))
        self.cam_mlp = nn.Sequential(
            Linear(width * LENS_VALUES, time_dim * 2), SimpleGate(), Linear(time_dim, time_dim)
        )

    def forward(self, inp: torch.Tensor, cond: torch.Tensor, time, lens_info: Tuple) -> torch.Tensor:
        B, H, W, _ = inp.shape

        def per_sample(v):
            return torch.as_tensor(v, dtype=torch.float32, device=inp.device).reshape(-1).expand(B)

        t = self.time_mlp(sinusoidal_pos_emb(per_sample(time), self.width))
        cam = torch.cat([sinusoidal_pos_emb(per_sample(v), self.width) for v in lens_info], dim=-1)
        cam = self.cam_mlp(cam)

        x = check_image_size(torch.cat([inp - cond, cond], dim=-1), self.padder_size, mode="zeros")
        x = x.to(self.dtype).contiguous().permute(0, 3, 1, 2)  # channels_last NCHW
        x = self.pyramid(x, lambda blocks, x: run_blocks(blocks, x, t, cam))
        return x.permute(0, 2, 3, 1)[:, :H, :W, :].float()
