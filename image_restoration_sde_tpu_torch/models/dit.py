"""DiT score network, Refusion's transformer backbone (PyTorch).

Counterpart of ``image_restoration_sde_tpu/models/dit.py``: a p x p
stride-p patch embedding of ``concat([x - cond, cond])`` (reflect-padded to
the patch size), a GLIDE timestep embedding (cos first, 256 frequencies)
through a two-layer MLP, adaLN-Zero blocks (6-way modulation from the time
embedding; attention, then a GELU(tanh) MLP), a 2-way modulated final
layer and unpatchify, cropped back to the input size.  Initialised as the
flax module: the modulations and the final linear map zero (so a fresh
net returns 0), every other layer ``modules.lecun_normal_``.  No positional
embedding, as in the reference.  Module names follow the reference torch
DiT, the key space ``utils/torch_import.dit_key_rules`` maps.

Attention runs through ``ops/flash_attention.py`` (kernel K4) at every
token count; ``plain=True`` takes its plain version.  The token LayerNorms
(no affine, eps 1e-6) are ``F.layer_norm`` and the dense layers cuBLAS, as
the JAX package leaves them to XLA.

Mixed precision as flax: parameters stay float32 and each layer computes
in the compute ``dtype``, except the timestep MLP, which computes in
float32 on float32 copies of its weights (a dtype-less flax Dense), also
when a caller has cast the parameters (``sampling.make_noise_fn``).
``forward`` takes and returns NHWC float32.

Tensor parallelism (:meth:`DiT.tensor_parallel_plan`, Megatron's splits;
``parallel/tensor.py``): each block's attention by head (``qkv`` by column
inside each of q, k and v, so K4 runs unchanged on each rank's heads;
``proj`` by row), its MLP column then row, its adaLN modulation by column
inside each of its 6 chunks and gathered; the timestep MLP column then
row, the final layer's modulation as the blocks'.  The patch embedding and
the final linear stay whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_mha, flash_mha_plain
from ..parallel.tensor import COLUMN, ROW, Split
from .modules import Conv2d, Linear, check_image_size

MLP_RATIO = 4
FREQ_DIM = 256


def glide_timestep_embedding(t: torch.Tensor) -> torch.Tensor:
    """cos-first sinusoidal embedding of FREQ_DIM channels (periods up to
    10000), float32."""
    half = FREQ_DIM // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _token_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class Attention(nn.Module):
    """timm-style: fused qkv (with bias), per-head scaling, output proj.  The
    heads are as many as ``qkv``'s output holds: all of them, or a model
    rank's under tensor parallelism."""

    def __init__(self, hidden: int, heads: int, plain: bool = False):
        super().__init__()
        self.heads, self.head_dim, self.plain = heads, hidden // heads, plain
        self.qkv = Linear(hidden, 3 * hidden)
        self.proj = Linear(hidden, hidden)

    def forward(self, x):
        B, N, _ = x.shape
        dh = self.head_dim
        # q, k, v are strided views of the packed product: no copies
        q, k, v = self.qkv(x).view(B, N, 3, -1, dh).unbind(2)
        attn = flash_mha_plain if self.plain else flash_mha
        return self.proj(attn(q, k, v, dh**-0.5).reshape(B, N, -1))


class Mlp(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.fc1 = Linear(hidden, MLP_RATIO * hidden)
        self.fc2 = Linear(MLP_RATIO * hidden, hidden)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _zeros(layer: Linear) -> Linear:
    nn.init.zeros_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class DiTBlock(nn.Module):
    """adaLN-Zero block: the modulation starts at zero weight and bias, so
    a fresh block's gates are closed and it passes its input through."""

    def __init__(self, hidden: int, heads: int, plain: bool = False):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), _zeros(Linear(hidden, 6 * hidden)))
        self.attn = Attention(hidden, heads, plain=plain)
        self.mlp = Mlp(hidden)

    def forward(self, x, c):
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + g_msa[:, None, :] * self.attn(modulate(_token_norm(x), s_msa, sc_msa))
        return x + g_mlp[:, None, :] * self.mlp(modulate(_token_norm(x), s_mlp, sc_mlp))


class FinalLayer(nn.Module):
    """Modulated LayerNorm and the linear map to patch pixels, both zero at
    the start: a fresh DiT outputs exactly 0."""

    def __init__(self, hidden: int, patch: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), _zeros(Linear(hidden, 2 * hidden)))
        self.linear = _zeros(Linear(hidden, patch * patch * out_channels))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(_token_norm(x), shift, scale))


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(Linear(FREQ_DIM, hidden), nn.SiLU(), Linear(hidden, hidden))

    def forward(self, t):
        # float32 input: each layer computes on float32 copies of its weights
        return self.mlp(glide_timestep_embedding(t))


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, hidden: int, patch: int):
        super().__init__()
        self.proj = Conv2d(in_channels, hidden, patch, stride=patch)


class DiT(nn.Module):
    def __init__(
        self,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        dtype: torch.dtype = torch.float32,
        plain: bool = False,
    ):
        super().__init__()
        self.patch_size, self.in_channels, self.dtype = patch_size, in_channels, dtype
        self.patch_embed = PatchEmbed(2 * in_channels, hidden_size, patch_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.blocks = nn.ModuleList([DiTBlock(hidden_size, num_heads, plain=plain) for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, patch_size, in_channels)

    def forward(self, inp: torch.Tensor, cond: torch.Tensor, time) -> torch.Tensor:
        B, H, W, _ = inp.shape
        p, out_ch = self.patch_size, self.in_channels
        time = torch.as_tensor(time, dtype=torch.float32, device=inp.device).reshape(-1).expand(B)

        x = check_image_size(torch.cat([inp - cond, cond], dim=-1), p, mode="reflect")
        Hp, Wp = x.shape[1], x.shape[2]
        x = self.patch_embed.proj(x.to(self.dtype).permute(0, 3, 1, 2))  # (B, hidden, Hp/p, Wp/p)
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)  # (B, N, hidden) tokens, row-major over the patch grid

        t = self.t_embedder(time).to(self.dtype)
        for blk in self.blocks:
            x = blk(x, t)
        x = self.final_layer(x, t)

        x = x.reshape(B, gh, gw, p, p, out_ch).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, out_ch)
        return x[:, :H, :W, :].float()

    def tensor_parallel_plan(self, size: int) -> dict:
        """The Megatron splits over ``size`` model ranks (module name ->
        ``Split``); the heads must divide by ``size``."""
        heads = self.blocks[0].attn.heads if len(self.blocks) else size
        if heads % size:
            raise ValueError(f"tensor parallelism: DiT's {heads} heads do not divide by model_parallel={size}")
        plan = {"t_embedder.mlp.0": Split(COLUMN), "t_embedder.mlp.2": Split(ROW),
                "final_layer.adaLN_modulation.1": Split(COLUMN, 2, gather=True)}
        for i in range(len(self.blocks)):
            b = f"blocks.{i}"
            plan.update({f"{b}.adaLN_modulation.1": Split(COLUMN, 6, gather=True),
                         f"{b}.attn.qkv": Split(COLUMN, 3), f"{b}.attn.proj": Split(ROW),
                         f"{b}.mlp.fc1": Split(COLUMN), f"{b}.mlp.fc2": Split(ROW)})
        return plan


def _sized(hidden: int, depth: int, heads: int, patch: int):
    def ctor(**kw) -> DiT:
        kw.setdefault("hidden_size", hidden)
        kw.setdefault("depth", depth)
        kw.setdefault("num_heads", heads)
        kw.setdefault("patch_size", patch)
        return DiT(**kw)

    return ctor


# size ladder (the JAX package's dit.py, after the reference DiT_arch.py)
DiT_XL_2 = _sized(1152, 28, 16, 2)
DiT_XL_4 = _sized(1152, 28, 16, 4)
DiT_XL_8 = _sized(1152, 28, 16, 8)
DiT_L_2 = _sized(1024, 24, 16, 2)
DiT_L_4 = _sized(1024, 24, 16, 4)
DiT_L_8 = _sized(1024, 24, 16, 8)
DiT_B_2 = _sized(768, 12, 12, 2)
DiT_B_4 = _sized(768, 12, 12, 4)
DiT_B_8 = _sized(768, 12, 12, 8)
DiT_S_2 = _sized(384, 12, 6, 2)
DiT_S_4 = _sized(384, 12, 6, 4)
DiT_S_8 = _sized(384, 12, 6, 8)
LADDER = {f"DiT_{s}_{p}": globals()[f"DiT_{s}_{p}"] for s in ("S", "B", "L", "XL") for p in (2, 4, 8)}
