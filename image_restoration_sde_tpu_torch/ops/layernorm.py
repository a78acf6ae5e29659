"""Channel LayerNorm over the trailing axis: CUDA kernel K1 and its plain
PyTorch version.

    y = (x - mean_C) * rsqrt(var_C + eps) * g,   f32 statistics,

with ``y`` in ``x``'s dtype.  Counterpart of
``image_restoration_sde_tpu/ops/layernorm.py`` (``channel_layernorm``); the
kernel is ``csrc/layernorm.cu``.

:func:`channel_layernorm` launches the kernel on a CUDA tensor and runs the
plain version on a CPU tensor.  It is differentiable: its backward is the
autograd of the plain version on the saved ``(x, g)``, as the JAX op's
custom_vjp takes the vjp of its jnp composition.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

LAYERNORM = kernels.Kernel(
    "irsde_channel_layernorm",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    source="image_restoration_sde_tpu_torch/csrc/layernorm.cu",
    replaces="image_restoration_sde_tpu/ops/layernorm.py:34",
)


def channel_layernorm_plain(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """x: (..., C), g: (C,).  Centered variance, f32 statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


def channel_layernorm_cuda(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch K1 on a contiguous CUDA tensor (..., C), float32 or bfloat16."""
    C = x.shape[-1]
    code = kernels.dtype_code(x.dtype)
    if not x.is_cuda:
        raise ValueError(f"channel_layernorm_cuda: x is on {x.device}, not a CUDA device")
    if not x.is_contiguous():
        raise ValueError("channel_layernorm: x must be contiguous over (rows, C)")
    if C % (16 // x.element_size()) or C * x.element_size() > 4096:
        raise ValueError(f"channel_layernorm: unsupported C={C} for {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("channel_layernorm: x must be 16-byte aligned")
    if g.numel() != C:
        raise ValueError(f"channel_layernorm: g has {g.numel()} entries, C={C}")
    g = g.reshape(C).to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // C
    if rows:
        LAYERNORM(kernels.ptr(x), kernels.ptr(g), kernels.ptr(y), rows, C, eps, code,
                  kernels.current_stream(x.device))
    return y


def _forward(x, g, eps):
    if x.is_cuda:
        return channel_layernorm_cuda(x, g, eps)
    if x.device.type == "cpu":
        return channel_layernorm_plain(x, g, eps)
    raise ValueError(f"channel_layernorm: no implementation for device {x.device}")


class _ChannelLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return _forward(x, g, eps)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = channel_layernorm_plain(*inputs, ctx.eps)
        return (*torch.autograd.grad(y, inputs, grad), None)


def channel_layernorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., C), g: (C,); differentiable.  The kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    return _ChannelLayerNorm.apply(x, g, eps)
