"""The score networks and the compressor in plain float32 PyTorch.

Written from the published architectures (the IR-SDE repository's
ConditionalUNet, Refusion's ConditionalNAFNet and latent UNet), NCHW and
float32 throughout, with the parameter names of their state dicts, so one
set of weights made by the benchmark loads into the reference and into the
port alike.  Every layer reads a shared :class:`Ctx`:

- ``prec``: the precision each convolution and dense layer computes in
  (``precision.py``: float32 for the reference, lower for its control);
- ``eps``: the channel LayerNorm's epsilon, which the published models tie
  to the compute dtype (1e-5 in float32, 1e-3 in bfloat16);
- ``sites``: where a list, each call of an operation that the port runs as
  a kernel of its own appends ``(kernel, shape)``: ``k1`` a channel
  LayerNorm ``(rows, C, itemsize)``, ``k2`` a linear attention ``(B, N,
  itemsize)``, ``k3`` a level of at least four NAFBlocks ``(B, H, W, C,
  K, itemsize)`` (whose LayerNorms are then its own); ``itemsize`` is the
  bytes of an element in the configuration's compute dtype.  The kernels'
  work files (``benchmark/work``) price those calls.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .precision import Precision

K3_MIN_BLOCKS = 4
K3_CHANNEL_MULTIPLE = 8


class Ctx:
    def __init__(self, prec: Optional[Precision] = None, eps: float = 1e-5, itemsize: int = 4):
        self.prec = prec or Precision()
        self.eps = eps
        self.itemsize = itemsize
        self.sites: Optional[List[tuple]] = None
        self.in_stack = False

    def site(self, *entry) -> None:
        if self.sites is not None and not self.in_stack:
            self.sites.append(entry)


class Conv(nn.Module):
    def __init__(self, ctx: Ctx, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, groups: int = 1):
        super().__init__()
        self.ctx, self.stride, self.padding, self.groups = ctx, stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return self.ctx.prec.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.groups)


class Dense(nn.Module):
    def __init__(self, ctx: Ctx, cin: int, cout: int):
        super().__init__()
        self.ctx = ctx
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return self.ctx.prec.linear(x, self.weight, self.bias)


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal(t, self.dim)


class ChannelLayerNorm(nn.Module):
    """Bias-free LayerNorm over channels of NCHW, centred variance."""

    def __init__(self, ctx: Ctx, dim: int):
        super().__init__()
        self.ctx = ctx
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        B, C, H, W = x.shape
        self.ctx.site("k1", B * H * W, C, self.ctx.itemsize)
        mean = x.mean(1, keepdim=True)
        var = (x - mean).square().mean(1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.ctx.eps) * self.g


class LinearAttention(nn.Module):
    """Channel attention of four heads of 32: softmax of q over each head's
    channels, of k over the positions, a head's 32 x 32 context, a 1x1
    projection and a channel LayerNorm."""

    def __init__(self, ctx: Ctx, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.ctx, self.heads, self.dim_head = ctx, heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv(ctx, dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv(ctx, hidden, dim, 1), ChannelLayerNorm(ctx, dim))

    def forward(self, x):
        B, _, H, W = x.shape
        h, d = self.heads, self.dim_head
        self.ctx.site("k2", B, H * W, self.ctx.itemsize)
        q, k, v = self.to_qkv(x).reshape(B, 3, h, d, H * W).unbind(1)  # (B, h, d, N)
        q = torch.softmax(q, dim=2) * d**-0.5
        k = torch.softmax(k, dim=3)
        context = torch.einsum("bhdn,bhen->bhde", k, v / (H * W))
        out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(B, h * d, H, W)
        return self.to_out(self.ctx.prec.round(out))


class PreNormResidual(nn.Module):
    """x + fn(LayerNorm(x)), the repository's Residual(PreNorm(dim, fn))."""

    def __init__(self, ctx: Ctx, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = nn.Module()
        self.fn.fn, self.fn.norm = fn, ChannelLayerNorm(ctx, dim)

    def forward(self, x):
        return self.fn.fn(self.fn.norm(x)) + x


class Block(nn.Module):
    def __init__(self, ctx: Ctx, dim: int, dim_out: int):
        super().__init__()
        self.proj = Conv(ctx, dim, dim_out, 3, padding=1, bias=False)

    def forward(self, x, scale_shift=None):
        x = self.proj(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class ResBlock(nn.Module):
    def __init__(self, ctx: Ctx, dim: int, dim_out: int, time_dim: Optional[int] = None):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), Dense(ctx, time_dim, dim_out * 2)) if time_dim else None
        self.block1 = Block(ctx, dim, dim_out)
        self.block2 = Block(ctx, dim_out, dim_out)
        self.res_conv = Conv(ctx, dim, dim_out, 1, bias=False) if dim != dim_out else nn.Identity()

    def forward(self, x, temb=None):
        scale_shift = None
        if self.mlp is not None:
            scale_shift = self.mlp(temb)[:, :, None, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + self.res_conv(x)


def downsample(ctx: Ctx, dim: int, dim_out: int) -> nn.Module:
    return Conv(ctx, dim, dim_out, 4, 2, 1)


def upsample(ctx: Ctx, dim: int, dim_out: int) -> nn.Module:
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"), Conv(ctx, dim, dim_out, 3, padding=1))


def pad_to(x: torch.Tensor, multiple: int, mode: str) -> torch.Tensor:
    """NCHW ``x`` padded at the bottom and right to a multiple."""
    H, W = x.shape[2:]
    ph, pw = (-H) % multiple, (-W) % multiple
    if not (ph or pw):
        return x
    return F.pad(x, (0, pw, 0, ph), mode="reflect" if mode == "reflect" else "constant")


class ConditionalUNet(nn.Module):
    """IR-SDE's score net: ``net(x_t, mu, t) -> noise`` on NHWC images."""

    def __init__(self, ctx: Ctx, in_nc: int, out_nc: int, nf: int, depth: int):
        super().__init__()
        self.ctx, self.depth = ctx, depth
        time_dim = nf * 4
        self.init_conv = Conv(ctx, in_nc * 2, nf, 7, padding=3, bias=False)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(nf), Dense(ctx, nf, time_dim), nn.GELU(),
                                      Dense(ctx, time_dim, time_dim))
        self.downs, self.ups = nn.ModuleList(), nn.ModuleList()
        for i in range(depth):
            dim_in, dim_out = nf * 2**i, nf * 2 ** (i + 1)
            last = i == depth - 1
            self.downs.append(nn.ModuleList([
                ResBlock(ctx, dim_in, dim_in, time_dim), ResBlock(ctx, dim_in, dim_in, time_dim),
                PreNormResidual(ctx, dim_in, LinearAttention(ctx, dim_in)),
                Conv(ctx, dim_in, dim_out, 3, padding=1, bias=False) if last else downsample(ctx, dim_in, dim_out),
            ]))
            self.ups.insert(0, nn.ModuleList([
                ResBlock(ctx, dim_out + dim_in, dim_out, time_dim), ResBlock(ctx, dim_out + dim_in, dim_out, time_dim),
                PreNormResidual(ctx, dim_out, LinearAttention(ctx, dim_out)),
                Conv(ctx, dim_out, dim_in, 3, padding=1, bias=False) if i == 0 else upsample(ctx, dim_out, dim_in),
            ]))
        mid = nf * 2**depth
        self.mid_block1 = ResBlock(ctx, mid, mid, time_dim)
        self.mid_attn = PreNormResidual(ctx, mid, LinearAttention(ctx, mid))
        self.mid_block2 = ResBlock(ctx, mid, mid, time_dim)
        self.final_res_block = ResBlock(ctx, nf * 2, nf, time_dim)
        self.final_conv = Conv(ctx, nf, out_nc, 3, padding=1)

    def forward(self, xt, cond, time):
        B, H, W, _ = xt.shape
        time = torch.as_tensor(time, dtype=torch.float32, device=xt.device).reshape(-1).expand(B)
        x = torch.cat([xt - cond, cond], dim=-1).permute(0, 3, 1, 2)
        x = pad_to(x, 2**self.depth, "reflect")
        x = self.init_conv(x)
        stem = x
        t = self.time_mlp(time)
        skips = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t)
            skips.append(x)
            x = attn(block2(x, t))
            skips.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t)), t)
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, skips.pop()], dim=1), t)
            x = block2(torch.cat([x, skips.pop()], dim=1), t)
            x = up(attn(x))
        x = self.final_conv(self.final_res_block(torch.cat([x, stem], dim=1), t))
        return x[:, :, :H, :W].permute(0, 2, 3, 1)


class LatentUNet(nn.Module):
    """Refusion's compressor: ``encode(image) -> (latent, skips)``,
    ``decode(latent, skips) -> image``, NHWC images and latents."""

    def __init__(self, ctx: Ctx, in_ch: int, out_ch: int, ch: int, ch_mult: Sequence[int], embed_dim: int):
        super().__init__()
        self.ctx, self.depth = ctx, len(ch_mult)
        mult = [1, *ch_mult]
        self.init_conv = Conv(ctx, in_ch, ch, 3, padding=1, bias=False)
        self.encoder, self.decoder = nn.ModuleList(), nn.ModuleList()
        for i in range(self.depth):
            dim_in, dim_out = ch * mult[i], ch * mult[i + 1]
            last = i == self.depth - 1

            def attn(dim):
                return PreNormResidual(ctx, dim, LinearAttention(ctx, dim)) if last else nn.Identity()

            self.encoder.append(nn.ModuleList([
                ResBlock(ctx, dim_in, dim_in), ResBlock(ctx, dim_in, dim_in), attn(dim_in),
                Conv(ctx, dim_in, dim_out, 3, padding=1, bias=False) if last else downsample(ctx, dim_in, dim_out),
            ]))
            self.decoder.insert(0, nn.ModuleList([
                ResBlock(ctx, dim_out + dim_in, dim_out), ResBlock(ctx, dim_out + dim_in, dim_out), attn(dim_out),
                Conv(ctx, dim_out, dim_in, 3, padding=1, bias=False) if i == 0 else upsample(ctx, dim_out, dim_in),
            ]))
        mid = ch * mult[-1]
        self.latent_conv = Conv(ctx, mid, embed_dim, 1, bias=False)
        self.post_latent_conv = Conv(ctx, embed_dim, mid, 1, bias=False)
        self.final_conv = Conv(ctx, ch, out_ch, 3, padding=1)

    def encode(self, img):
        x = self.init_conv(pad_to(img.permute(0, 3, 1, 2), 2**self.depth, "reflect"))
        hs = [x]
        for block1, block2, attn, down in self.encoder:
            x = block1(x)
            hs.append(x)
            x = attn(block2(x))
            hs.append(x)
            x = down(x)
        return self.latent_conv(x).permute(0, 2, 3, 1), hs

    def decode(self, latent, hs, hw):
        x = self.post_latent_conv(latent.permute(0, 3, 1, 2))
        for k, (block1, block2, attn, up) in enumerate(self.decoder):
            x = block1(torch.cat([x, hs[-(2 * k + 1)]], dim=1))
            x = block2(torch.cat([x, hs[-(2 * k + 2)]], dim=1))
            x = up(attn(x))
        x = self.final_conv(x + hs[0]).permute(0, 2, 3, 1)
        return x[:, : hw[0], : hw[1], :]


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=1)
    return x1 * x2


class NAFBlock(nn.Module):
    def __init__(self, ctx: Ctx, c: int, time_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Identity(), Dense(ctx, time_dim // 2, c * 4))
        self.conv1 = Conv(ctx, c, 2 * c, 1)
        self.conv2 = Conv(ctx, 2 * c, 2 * c, 3, padding=1, groups=2 * c)
        self.conv3 = Conv(ctx, c, c, 1)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv(ctx, c, c, 1))
        self.conv4 = Conv(ctx, c, 2 * c, 1)
        self.conv5 = Conv(ctx, c, c, 1)
        self.norm1 = ChannelLayerNorm(ctx, c)
        self.norm2 = ChannelLayerNorm(ctx, c)
        self.beta = nn.Parameter(torch.empty(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.empty(1, c, 1, 1))

    def forward(self, x, temb):
        mod = self.mlp[1](simple_gate(temb))[:, :, None, None]
        shift_att, scale_att, shift_ffn, scale_ffn = mod.chunk(4, dim=1)
        inp = x
        x = self.norm1(x) * (scale_att + 1) + shift_att
        x = simple_gate(self.conv2(self.conv1(x)))
        x = self.conv3(x * self.sca(x))
        y = inp + x * self.beta
        x = self.norm2(y) * (scale_ffn + 1) + shift_ffn
        x = self.conv5(simple_gate(self.conv4(x)))
        return y + x * self.gamma


class PixelShuffleUp(nn.Sequential):
    def __init__(self, ctx: Ctx, chan: int):
        super().__init__(Conv(ctx, chan, chan * 2, 1, bias=False), nn.PixelShuffle(2))


class ConditionalNAFNet(nn.Module):
    """Refusion's score net: ``net(x_t, mu, t) -> noise`` on NHWC latents."""

    def __init__(self, ctx: Ctx, img_channel: int, width: int, middle_blk_num: int,
                 enc_blk_nums: Sequence[int], dec_blk_nums: Sequence[int]):
        super().__init__()
        self.ctx = ctx
        time_dim = width * 4
        self.padder_size = 2 ** len(enc_blk_nums)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(width), Dense(ctx, width, time_dim * 2), nn.Identity(),
                                      Dense(ctx, time_dim, time_dim))
        self.intro = Conv(ctx, img_channel * 2, width, 3, padding=1)
        self.ending = Conv(ctx, width, img_channel, 3, padding=1)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()

        def level(chan, num):
            return nn.ModuleList([NAFBlock(ctx, chan, time_dim) for _ in range(num)])

        chan = width
        for num in enc_blk_nums:
            self.encoders.append(level(chan, num))
            self.downs.append(Conv(ctx, chan, 2 * chan, 2, 2))
            chan *= 2
        self.middle_blks = level(chan, middle_blk_num)
        for num in dec_blk_nums:
            self.ups.append(PixelShuffleUp(ctx, chan))
            chan //= 2
            self.decoders.append(level(chan, num))

    def run_level(self, blocks: nn.ModuleList, x, t):
        B, C, H, W = x.shape
        stack = len(blocks) >= K3_MIN_BLOCKS and C % K3_CHANNEL_MULTIPLE == 0
        if stack:
            self.ctx.site("k3", B, H, W, C, len(blocks), self.ctx.itemsize)
        self.ctx.in_stack = stack
        try:
            for blk in blocks:
                x = blk(x, t)
        finally:
            self.ctx.in_stack = False
        return x

    def forward(self, inp, cond, time):
        B, H, W, _ = inp.shape
        time = torch.as_tensor(time, dtype=torch.float32, device=inp.device).reshape(-1).expand(B)
        t = self.time_mlp[3](simple_gate(self.time_mlp[1](self.time_mlp[0](time))))
        x = pad_to(torch.cat([inp - cond, cond], dim=-1).permute(0, 3, 1, 2), self.padder_size, "zeros")
        x = self.intro(x)
        skips = []
        for blocks, down in zip(self.encoders, self.downs):
            x = self.run_level(blocks, x, t)
            skips.append(x)
            x = down(x)
        x = self.run_level(self.middle_blks, x, t)
        for up, blocks, skip in zip(self.ups, self.decoders, reversed(skips)):
            x = self.run_level(blocks, up(x) + skip, t)
        return self.ending(x)[:, :, :H, :W].permute(0, 2, 3, 1)


NETWORKS = {"ConditionalUNet": ConditionalUNet, "UNet": LatentUNet, "ConditionalNAFNet": ConditionalNAFNet}


def network(part: dict, which: str, prec: Precision) -> nn.Module:
    """The network ``which`` for a configuration's part, which has to name
    it: a configuration naming another network has no reference here."""
    if part["which"] != which:
        raise ValueError(f"this reference builds {which}, not the configuration's {part['which']}")
    f32 = part["compute_dtype"] == "float32"
    ctx = Ctx(prec, eps=1e-5 if f32 else 1e-3, itemsize=4 if f32 else 2)
    return NETWORKS[which](ctx, **part["setting"])
