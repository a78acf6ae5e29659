"""Building blocks of the score networks (PyTorch).

Counterpart of the parts of ``image_restoration_sde_tpu/models/modules.py``
that the port's networks use.  Module and parameter names follow the
reference torch repository, so its ``state_dict`` keys load as they are.

Layout: tensors are NCHW in ``torch.channels_last`` memory, so the channel
LayerNorm and the linear attention see contiguous ``(B*H*W, C)`` rows.
Mixed precision as in flax: parameters stay float32 and each op casts them
to the dtype of its input, which is the compute dtype; norm statistics and
softmaxes run in float32 inside the ops.

Every module that holds a kernel takes ``plain``: False (the default) runs
the kernel on CUDA tensors; True runs the plain PyTorch version on any
device, which is how the kernel path is compared with the plain path on
the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm import channel_layernorm, channel_layernorm_plain
from ..ops.linear_attention import linear_attention_packed, linear_attention_packed_plain


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding: half sin, half cos, with frequencies
    exp(-log(10000) * i / (half - 1))."""
    t = t.float()
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(10000.0) / (half - 1))
    )
    args = t[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_pos_emb(t, self.dim)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Fourier features of the timestep on ``dim // 2`` frequencies
    ``weights`` (drawn N(0, 1); learned, or frozen where ``is_random``):
    ``[t, sin(2 pi t w), cos(2 pi t w)]``, ``dim + 1`` channels, float32."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        if dim % 2:
            raise ValueError(f"RandomOrLearnedSinusoidalPosEmb: dim {dim} is odd")
        self.weights = nn.Parameter(torch.randn(dim // 2), requires_grad=not is_random)

    def forward(self, t):
        t = t.float()[:, None]
        freqs = t * self.weights.float()[None, :] * 2 * math.pi
        return torch.cat([t, freqs.sin(), freqs.cos()], dim=-1)


# flax's ``lecun_normal``: a normal truncated at two standard deviations,
# its std divided by the truncated one's (0.8796...) so that the draws
# have variance 1/fan_in
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """Draw ``weight`` (out first) as flax's default kernel initialiser
    does, from torch's global generator: std sigma' = sqrt(1/fan_in) /
    TRUNCATED_STD, truncated at 2 sigma'; fan_in is ``weight[0].numel()``
    (in/groups x kh x kw for a convolution, as flax's grouped kernel (kh,
    kw, in/groups, out) counts it).  Sampled as ``jax.random.
    truncated_normal`` samples, by the inverse CDF (a uniform between
    erf(-sqrt 2) and erf(sqrt 2) through erfinv): torch's ``trunc_normal_``
    rejects and redraws the whole tensor, ~8x the time on a large net."""
    std = weight[0].numel() ** -0.5 / TRUNCATED_STD
    edge = math.erf(math.sqrt(2.0))
    with torch.no_grad():
        return weight.uniform_(-edge, edge).erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2 * std, 2 * std)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 parameters are cast to the input's dtype;
    initialised as a flax ``nn.Conv``: ``lecun_normal_`` kernel, zero
    bias."""

    def reset_parameters(self):
        lecun_normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 parameters are cast to the input's dtype;
    initialised as a flax ``nn.Dense``: ``lecun_normal_`` kernel, zero
    bias."""

    reset_parameters = Conv2d.reset_parameters

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class ChannelLayerNorm(nn.Module):
    """Bias-free LayerNorm over channels; eps 1e-5 for float32 inputs, 1e-3
    otherwise; float32 statistics; output in the input's dtype."""

    def __init__(self, dim: int, plain: bool = False):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.plain = plain

    def forward(self, x):
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        ln = channel_layernorm_plain if self.plain else channel_layernorm
        return ln(x.permute(0, 2, 3, 1), self.g.reshape(-1), eps).permute(0, 3, 1, 2)


def Downsample(dim: int, dim_out: int) -> nn.Module:
    """4x4 stride-2 conv, padding 1, with bias."""
    return Conv2d(dim, dim_out, 4, 2, 1)


def Upsample(dim: int, dim_out: int) -> nn.Module:
    """Nearest 2x upsample, then a 3x3 conv with bias."""
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"), Conv2d(dim, dim_out, 3, padding=1))


class Block(nn.Module):
    """conv -> optional x * (scale + 1) + shift -> SiLU."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Conv2d(dim, dim_out, 3, padding=1, bias=False)

    def forward(self, x, scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        x = self.proj(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class ResBlock(nn.Module):
    """Two conv blocks with a time scale/shift on the first, and a 1x1
    residual conv where the width changes."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None):
        super().__init__()
        self.mlp = (
            nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim_out * 2)) if time_emb_dim else None
        )
        self.block1 = Block(dim, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.res_conv = Conv2d(dim, dim_out, 1, bias=False) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb: Optional[torch.Tensor] = None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            t = self.mlp(time_emb.to(x.dtype))[:, :, None, None]
            scale_shift = t.chunk(2, dim=1)  # scale first, then shift
        h = self.block1(x, scale_shift=scale_shift)
        h = self.block2(h)
        return h + self.res_conv(x)


class LinearAttention(nn.Module):
    """Channel ("linear") attention: softmax(q) over each head's channels,
    softmax(k) over space, 1x1 projections, LayerNorm on the output."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, plain: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.plain = heads, dim_head, plain
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv2d(hidden, dim, 1), ChannelLayerNorm(dim, plain=plain))

    def forward(self, x):
        B, _, H, W = x.shape
        # the 1x1 conv's channels_last output is already the packed
        # (B, N, 3*hidden) layout: a view, no copy
        qkv = self.to_qkv(x).permute(0, 2, 3, 1).view(B, H * W, -1)
        attn = linear_attention_packed_plain if self.plain else linear_attention_packed
        out = attn(qkv, self.heads, self.dim_head)
        return self.to_out(out.view(B, H, W, -1).permute(0, 3, 1, 2))


class Attention(nn.Module):
    """Full spatial self-attention (the unconditional UNet's mid block):
    q k^T, softmax and p v in float32 with torch matmuls, a 1x1 projection
    back and no output LayerNorm.  The JAX package computes it with XLA
    einsums, not a Pallas kernel."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x):
        B, _, H, W = x.shape
        hidden = self.heads * self.dim_head
        qkv = self.to_qkv(x).permute(0, 2, 3, 1).reshape(B, H * W, 3, self.heads, self.dim_head)
        q, k, v = (t.float().transpose(1, 2) for t in qkv.unbind(2))  # (B, h, N, d)
        sim = torch.matmul(q * self.dim_head**-0.5, k.transpose(-1, -2))
        out = torch.matmul(torch.softmax(sim, dim=-1), v)  # (B, h, N, d)
        out = out.transpose(1, 2).reshape(B, H, W, hidden).to(x.dtype)
        return self.to_out(out.permute(0, 3, 1, 2))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, plain: bool = False):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim, plain=plain)

    def forward(self, x):
        return self.fn(self.norm(x))


class PreNormResidual(nn.Module):
    """x + fn(LayerNorm(x)): the reference's Residual(PreNorm(dim, fn))."""

    def __init__(self, dim: int, fn: nn.Module, plain: bool = False):
        super().__init__()
        self.fn = PreNorm(dim, fn, plain=plain)

    def forward(self, x):
        return self.fn(x) + x


def check_image_size(x: torch.Tensor, multiple: int, mode: str = "reflect") -> torch.Tensor:
    """Pad NHWC ``x`` at the bottom/right to a multiple of ``multiple``:
    ``mode`` "reflect" (the UNets) or "zeros" (the NAFNet)."""
    if mode not in ("reflect", "zeros"):
        raise ValueError(f"check_image_size: mode {mode!r}; options: reflect, zeros")
    _, H, W, _ = x.shape
    pad_h = (multiple - H % multiple) % multiple
    pad_w = (multiple - W % multiple) % multiple
    if pad_h == 0 and pad_w == 0:
        return x
    if mode == "zeros":
        return F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    y = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect")
    return y.permute(0, 2, 3, 1).contiguous()


def local_avg_pool(x: torch.Tensor, k1: int, k2: int) -> torch.Tensor:
    """TLSC's windowed mean of NCHW ``x``, the same size out: k1 x k2 window
    sums from a zero-padded 2-D cumulative sum in float32 (over W, then H),
    over the window's area, replicate-padded back to the input's H and W;
    windows larger than the map are cut to it.  In ``x``'s dtype."""
    _, _, H, W = x.shape
    k1, k2 = min(H, k1), min(W, k2)
    s = F.pad(x.float().cumsum(3).cumsum(2), (1, 0, 1, 0))
    out = (s[:, :, k1:, k2:] + s[:, :, :-k1, :-k2] - s[:, :, :-k1, k2:] - s[:, :, k1:, :-k2]) / (k1 * k2)
    h, w = out.shape[2:]
    out = F.pad(out, ((W - w) // 2, (W - w + 1) // 2, (H - h) // 2, (H - h + 1) // 2), mode="replicate")
    return out.to(x.dtype)


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    """Split the channels (axis 1) in half and multiply the halves."""
    x1, x2 = x.chunk(2, dim=1)
    return x1 * x2


class SimpleGate(nn.Module):
    def forward(self, x):
        return simple_gate(x)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space as ``nn.PixelShuffle``, returned in channels_last
    memory: PixelShuffle's own output is NCHW-contiguous, and the kernels
    take contiguous (pixels, C) rows."""
    return F.pixel_shuffle(x, factor).contiguous(memory_format=torch.channels_last)


class PixelShuffle(nn.PixelShuffle):
    def forward(self, x):
        return pixel_shuffle(x, self.upscale_factor)


def bicubic_resize_weights(in_size: int, out_size: int, a: float = -0.75) -> np.ndarray:
    """Dense ``(out, in)`` float32 interpolation matrix equal to torch
    ``F.interpolate(mode="bicubic", align_corners=False)`` along one axis
    (no antialias; Keys kernel with a = -0.75, indices clamped at the
    borders): the JAX package's ``bicubic_resize_weights``, copied."""
    w = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        f = math.floor(src)
        t = src - f
        for off, dist in zip((-1, 0, 1, 2), (t + 1, t, 1 - t, 2 - t)):
            x = abs(dist)
            if x <= 1:
                wk = (a + 2) * x**3 - (a + 3) * x**2 + 1
            elif x < 2:
                wk = a * (x**3 - 5 * x**2 + 8 * x - 4)
            else:
                wk = 0.0
            idx = min(max(f + off, 0), in_size - 1)
            w[i, idx] += wk
    return w


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output index of a nearest resize that samples
    at half-pixel centres, in float32 as ``jax.image.resize(...,
    "nearest")`` computes it (torch's ``mode="nearest-exact"``; torch's
    legacy ``"nearest"`` differs where out_size is not a multiple of
    in_size)."""
    return np.floor((np.arange(out_size, dtype=np.float32) + 0.5) * in_size / out_size).astype(np.int64)
