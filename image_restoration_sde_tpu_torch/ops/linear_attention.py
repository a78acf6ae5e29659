"""Packed all-heads linear attention: CUDA kernels K2a (context) and K2b
(apply), and their plain PyTorch versions.

Counterpart of ``linear_attention_packed`` in
``image_restoration_sde_tpu/ops/linear_attention.py``.  The input is the
qkv projection ``(B, N, 3*heads*dim_head)`` with channels ordered
``[q heads | k heads | v heads]``; per head:

    ctxT[e, d] = sum_n softmax_N(k)[n, d] v[n, e] / N           (context)
    out[n, e]  = sum_d softmax_d(q)[n, d] dim_head^-1/2 ctxT[e, d] (apply)

``ctx`` is float32 ``(B, heads, dim_head, dim_head)`` indexed ``[b, h, e, d]``;
the output is ``(B, N, heads*dim_head)`` in the input's dtype.  The kernels
are ``csrc/linear_attention.cu``; they take dim_head = 32 and any N.

:func:`linear_attention_packed` launches the kernels on a CUDA tensor and
runs the plain versions on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

_SRC = "image_restoration_sde_tpu_torch/csrc/linear_attention.cu"
_V, _I = ctypes.c_void_p, ctypes.c_int

LA_CTX = kernels.Kernel(
    "irsde_la_ctx", [_V, _V, _V, _V, _I, _I, _I, _I, _V], source=_SRC,
    replaces="image_restoration_sde_tpu/ops/linear_attention.py:195",
)
LA_APPLY = kernels.Kernel(
    "irsde_la_apply", [_V, _V, _V, _I, _I, _I, _I, _V], source=_SRC,
    replaces="image_restoration_sde_tpu/ops/linear_attention.py:225",
)
KERNEL_DIM_HEAD = 32


def _split(qkv: torch.Tensor, heads: int, dim_head: int):
    B, N, _ = qkv.shape
    x = qkv.float().reshape(B, N, 3, heads, dim_head)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]  # (B, N, h, d)


def linear_attention_ctx_plain(qkv: torch.Tensor, heads: int = 4, dim_head: int = 32) -> torch.Tensor:
    _, k, v = _split(qkv, heads, dim_head)
    ks = torch.softmax(k, dim=1)
    return torch.einsum("bnhd,bnhe->bhed", ks, v / qkv.shape[1])


def linear_attention_apply_plain(
    qkv: torch.Tensor, ctx: torch.Tensor, heads: int = 4, dim_head: int = 32
) -> torch.Tensor:
    B, N, _ = qkv.shape
    q, _, _ = _split(qkv, heads, dim_head)
    qs = torch.softmax(q, dim=-1) * (dim_head**-0.5)
    out = torch.einsum("bnhd,bhed->bnhe", qs, ctx)
    return out.reshape(B, N, heads * dim_head).to(qkv.dtype)


def linear_attention_packed_plain(qkv: torch.Tensor, heads: int = 4, dim_head: int = 32) -> torch.Tensor:
    return linear_attention_apply_plain(
        qkv, linear_attention_ctx_plain(qkv, heads, dim_head), heads, dim_head
    )


def _check(qkv: torch.Tensor, heads: int, dim_head: int) -> int:
    if not qkv.is_cuda:
        raise ValueError(f"linear attention kernels: qkv is on {qkv.device}, not a CUDA device")
    if dim_head != KERNEL_DIM_HEAD:
        raise ValueError(f"linear attention kernels take dim_head={KERNEL_DIM_HEAD}, not {dim_head}")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * heads * dim_head:
        raise ValueError(f"qkv must be (B, N, {3 * heads * dim_head}), got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    return kernels.dtype_code(qkv.dtype)


def linear_attention_ctx_cuda(qkv: torch.Tensor, heads: int = 4, dim_head: int = 32) -> torch.Tensor:
    """Launch K2a: (B, N, 3*hid) CUDA tensor -> float32 ctx (B, heads, 32, 32)."""
    code = _check(qkv, heads, dim_head)
    B, N, _ = qkv.shape
    n_ws = kernels.load_library().irsde_la_ctx_workspace(B, N, heads)
    ws = torch.empty(n_ws, dtype=torch.float32, device=qkv.device)
    done = torch.zeros(B * heads, dtype=torch.int32, device=qkv.device)
    ctx = torch.empty(B, heads, dim_head, dim_head, dtype=torch.float32, device=qkv.device)
    LA_CTX(kernels.ptr(qkv), kernels.ptr(ctx), kernels.ptr(ws), kernels.ptr(done), B, N, heads,
           code, kernels.current_stream(qkv.device))
    return ctx


def linear_attention_apply_cuda(
    qkv: torch.Tensor, ctx: torch.Tensor, heads: int = 4, dim_head: int = 32
) -> torch.Tensor:
    """Launch K2b: (B, N, 3*hid) and float32 ctx -> (B, N, hid) in qkv's dtype."""
    code = _check(qkv, heads, dim_head)
    B, N, _ = qkv.shape
    if ctx.shape != (B, heads, dim_head, dim_head) or ctx.dtype != torch.float32:
        raise ValueError(f"ctx must be float32 {(B, heads, dim_head, dim_head)}")
    if ctx.device != qkv.device or not ctx.is_contiguous():
        raise ValueError("ctx must be contiguous, on qkv's device")
    out = torch.empty(B, N, heads * dim_head, dtype=qkv.dtype, device=qkv.device)
    LA_APPLY(kernels.ptr(qkv), kernels.ptr(ctx), kernels.ptr(out), B, N, heads, code,
             kernels.current_stream(qkv.device))
    return out


def linear_attention_packed(qkv: torch.Tensor, heads: int = 4, dim_head: int = 32) -> torch.Tensor:
    """(B, N, 3*heads*dim_head) -> (B, N, heads*dim_head).  The kernels for
    a CUDA tensor, the plain versions for a CPU tensor."""
    if qkv.is_cuda:
        ctx = linear_attention_ctx_cuda(qkv, heads, dim_head)
        return linear_attention_apply_cuda(qkv, ctx, heads, dim_head)
    if qkv.device.type == "cpu":
        return linear_attention_packed_plain(qkv, heads, dim_head)
    raise ValueError(f"linear_attention_packed: no implementation for device {qkv.device}")
