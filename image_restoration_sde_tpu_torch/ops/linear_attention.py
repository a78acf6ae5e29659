"""Linear (channel) attention: the packed all-heads op with CUDA kernels
K2a (context) and K2b (apply), the per-slice op ``linear_attention`` with
CUDA kernels K5 (context and apply), and their plain PyTorch versions.

Counterpart of ``linear_attention_packed`` and ``linear_attention`` in
``image_restoration_sde_tpu/ops/linear_attention.py``.

Packed: the input is the qkv projection ``(B, N, 3*heads*dim_head)`` with
channels ordered ``[q heads | k heads | v heads]``; per head:

    ctxT[e, d] = sum_n softmax_N(k)[n, d] v[n, e] / N           (context)
    out[n, e]  = sum_d softmax_d(q)[n, d] dim_head^-1/2 ctxT[e, d] (apply)

``ctx`` is float32 ``(B, heads, dim_head, dim_head)`` indexed ``[b, h, e, d]``;
the output is ``(B, N, heads*dim_head)`` in the input's dtype.  The kernels
are ``csrc/linear_attention.cu``; they take heads = 4, dim_head = 32 and
any N.  ``linear_attention_packed`` is differentiable: its backward is the
autograd of the plain composition on the saved qkv, as the JAX op's
custom_vjp is ``jax.vjp`` of its jnp composition.

Per slice: q, k, v are separate ``(BH, N, d)`` tensors, one head each:

    ctx[d, e]  = sum_n softmax_N(k)[n, d] v[n, e] / N              (context)
    out[n, e]  = sum_d softmax_d(q)[n, d] d^-1/2 ctx[d, e]          (apply)

in float32, returned in q's dtype.  The kernels are
``csrc/linear_attention_bh.cu``; they take d in ``KERNEL_HEAD_DIMS`` and any
N.  ``linear_attention`` is differentiable: its backward is the autograd of
the plain composition on the saved inputs, as the JAX op's custom_vjp is
``jax.vjp`` of its jnp composition.

:func:`linear_attention_packed` (the operator
``irsde::linear_attention_packed``) and :func:`linear_attention`
(``irsde::linear_attention``) launch the kernels on CUDA tensors and run the
plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

_SRC = "image_restoration_sde_tpu_torch/csrc/linear_attention.cu"
_SRC_BH = "image_restoration_sde_tpu_torch/csrc/linear_attention_bh.cu"
_V, _I = ctypes.c_void_p, ctypes.c_int

LA_CTX = kernels.Kernel(
    "irsde_la_ctx", [_V, _V, _V, _I, _I, _I, _I, _V], source=_SRC,
    replaces="image_restoration_sde_tpu/ops/linear_attention.py:195",
)
LA_APPLY = kernels.Kernel(
    "irsde_la_apply", [_V, _V, _V, _I, _I, _I, _I, _V], source=_SRC,
    replaces="image_restoration_sde_tpu/ops/linear_attention.py:225",
)
KERNEL_HEADS, KERNEL_DIM_HEAD = 4, 32
# K5 replaces both the resident and the N-tiled Pallas kernel (one function)
LIN_ATTN_CTX = kernels.Kernel(
    "irsde_lin_attn_ctx", [_V, _V, _V, _V, _I, _I, _I, _I, _V], source=_SRC_BH,
    replaces="image_restoration_sde_tpu/ops/linear_attention.py:46,102",
)
LIN_ATTN_APPLY = kernels.Kernel(
    "irsde_lin_attn_apply", [_V, _V, _V, _I, _I, _I, _I, _V], source=_SRC_BH,
    replaces="image_restoration_sde_tpu/ops/linear_attention.py:46,102",
)
KERNEL_HEAD_DIMS = (16, 32, 64)


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
    if heads != KERNEL_HEADS:
        raise ValueError(f"linear attention kernels take heads={KERNEL_HEADS}, not {heads}")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * heads * dim_head:
        raise ValueError(f"qkv must be (B, N, {3 * heads * dim_head}), got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    return kernels.dtype_code(qkv.dtype)


def linear_attention_ctx_cuda(qkv: torch.Tensor, heads: int = 4, dim_head: int = 32) -> torch.Tensor:
    """Launch K2a: (B, N, 3*hid) CUDA tensor -> float32 ctx (B, heads, 32, 32)."""
    code = _check(qkv, heads, dim_head)
    B, N, _ = qkv.shape
    n_ws = kernels.load_library().irsde_la_ctx_workspace(B, N, heads, code)
    ws = torch.empty(n_ws, dtype=torch.float32, device=qkv.device)
    ctx = torch.empty(B, heads, dim_head, dim_head, dtype=torch.float32, device=qkv.device)
    LA_CTX(kernels.ptr(qkv), kernels.ptr(ctx), kernels.ptr(ws), B, N, heads, code,
           kernels.current_stream(qkv.device))
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


def _packed_cuda(qkv, heads, dim_head):
    ctx = linear_attention_ctx_cuda(qkv, heads, dim_head)
    return linear_attention_apply_cuda(qkv, ctx, heads, dim_head)


def _packed_cpu(qkv, heads, dim_head):
    return linear_attention_packed_plain(qkv, heads, dim_head).contiguous()


def _packed_fake(qkv, heads, dim_head):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], heads * dim_head))


def _packed_setup(ctx, inputs, output):
    qkv, ctx.heads, ctx.dim_head = inputs
    ctx.save_for_backward(qkv)


def _packed_backward(ctx, grad):
    (gqkv,) = kernels.plain_grads(linear_attention_packed_plain, ctx.saved_tensors, grad, ctx.heads, ctx.dim_head)
    return gqkv, None, None


PACKED_OP = kernels.define_op(
    "linear_attention_packed(Tensor qkv, int heads, int dim_head) -> Tensor",
    cpu=_packed_cpu, cuda=_packed_cuda, fake=_packed_fake, backward=_packed_backward, setup_context=_packed_setup)


def linear_attention_packed(qkv: torch.Tensor, heads: int = 4, dim_head: int = 32) -> torch.Tensor:
    """(B, N, 3*heads*dim_head) -> (B, N, heads*dim_head); differentiable.
    The kernels for a CUDA tensor, the plain versions for a CPU tensor."""
    return PACKED_OP(qkv, heads, dim_head)


# ------------------------------------------------- per-slice op (K5)
def linear_attention_context_plain(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(BH, N, d) k and v -> float32 ctx (BH, d, d), indexed [bh, d, e]."""
    ks = torch.softmax(k.float(), dim=-2)
    return torch.einsum("bnd,bne->bde", ks, v.float() / k.shape[-2])


def linear_attention_apply_heads_plain(q: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """(BH, N, d) q and float32 ctx (BH, d, d) -> (BH, N, d) in q's dtype."""
    qs = torch.softmax(q.float(), dim=-1) * (q.shape[-1] ** -0.5)
    return torch.einsum("bde,bnd->bne", ctx, qs).to(q.dtype)


def linear_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_jnp_linear_attention`` in float32, returned in
    q's dtype."""
    return linear_attention_apply_heads_plain(q, linear_attention_context_plain(k, v))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes (a
    view into a larger tensor): the kernels read rows with 16-byte copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_heads(*ts: torch.Tensor) -> int:
    q = ts[0]
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"linear attention kernels: tensors on {[str(t.device) for t in ts]}, not a CUDA device")
    if q.dim() != 3 or q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"linear attention kernels take (BH, N, d) with d in {KERNEL_HEAD_DIMS}, "
                         f"got {tuple(q.shape)}")
    if any(t.shape != q.shape or t.dtype != q.dtype or t.device != q.device for t in ts):
        raise ValueError("q, k and v must share shape, dtype and device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k and v must be contiguous")
    return kernels.dtype_code(q.dtype)


def linear_attention_context_cuda(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K5's context pass: (BH, N, d) CUDA k, v -> float32 ctx (BH, d, d)."""
    code = _check_heads(k, v)
    k, v = _aligned(k), _aligned(v)
    BH, N, d = k.shape
    n_ws = kernels.load_library().irsde_lin_attn_ctx_workspace(BH, N, d, code)
    if n_ws <= 0:
        raise ValueError(f"linear attention kernels: no context plan for (BH, N, d) = {(BH, N, d)}")
    ws = torch.empty(n_ws, dtype=torch.float32, device=k.device)
    ctx = torch.empty(BH, d, d, dtype=torch.float32, device=k.device)
    LIN_ATTN_CTX(kernels.ptr(k), kernels.ptr(v), kernels.ptr(ctx), kernels.ptr(ws), BH, N, d, code,
                 kernels.current_stream(k.device))
    return ctx


def linear_attention_apply_heads_cuda(q: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """Launch K5's apply pass: (BH, N, d) CUDA q and float32 ctx -> (BH, N, d)
    in q's dtype."""
    code = _check_heads(q)
    BH, N, d = q.shape
    if ctx.shape != (BH, d, d) or ctx.dtype != torch.float32:
        raise ValueError(f"ctx must be float32 {(BH, d, d)}")
    if ctx.device != q.device or not ctx.is_contiguous():
        raise ValueError("ctx must be contiguous, on q's device")
    q = _aligned(q)
    out = torch.empty_like(q)
    LIN_ATTN_APPLY(kernels.ptr(q), kernels.ptr(ctx), kernels.ptr(out), BH, N, d, code,
                   kernels.current_stream(q.device))
    return out


def _heads_cuda(q, k, v):
    _check_heads(q, k, v)
    return linear_attention_apply_heads_cuda(q, linear_attention_context_cuda(k, v))


def _heads_cpu(q, k, v):
    return linear_attention_plain(q, k, v).contiguous()


def _heads_fake(q, k, v):
    return q.new_empty(q.shape)


def _heads_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _heads_backward(ctx, grad):
    return kernels.plain_grads(linear_attention_plain, ctx.saved_tensors, grad)


HEADS_OP = kernels.define_op(
    "linear_attention(Tensor q, Tensor k, Tensor v) -> Tensor",
    cpu=_heads_cpu, cuda=_heads_cuda, fake=_heads_fake, backward=_heads_backward, setup_context=_heads_setup)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(BH, N, d) q, k, v -> (BH, N, d) in q's dtype; differentiable.  The
    K5 kernels for CUDA tensors, the plain version for CPU tensors."""
    return HEADS_OP(q, k, v)
