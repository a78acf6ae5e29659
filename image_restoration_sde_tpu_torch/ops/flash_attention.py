"""Multi-head attention with an online softmax: CUDA kernel K4 and its plain
PyTorch version.

Counterpart of ``image_restoration_sde_tpu/ops/flash_attention.py``
(``flash_mha``, the forward ``_fa_kernel``) on (B, N, H, D) tensors, softmax
over the keys:

    s = q k^T * scale (float32 sums);  p = exp(s - max);  l = sum(p) (float32)
    out = (p rounded to v's dtype) @ v (float32 sums) / l,  in q's dtype.

``p`` is rounded before the division, as the Pallas kernel does; the JAX
package's einsum reference ``_ref_mha`` divides first and then rounds, so
the two differ in bfloat16.  The kernel is ``csrc/flash_attention.cu``:
tensor-core products in bfloat16 (``wgmma`` with TMA-fed 128-key tiles at
both head dims; at 72 each row is a 128-byte and a 32-byte swizzled part)
and in float32
(``mma.sync`` TF32 on ``F32_KEY_TILE``-key tiles, each operand split into
two TF32 halves rounded to nearest, three products a_lo b_hi + a_hi b_lo +
a_hi b_hi: float32 accuracy, bound by three TF32 products at 494.7 TFLOP/s
rather than one float32 product on the FMA units at 67), any N, q/k/v with
any batch and token stride (the (B, N, 3, H, D) view of a packed qkv
product goes in as it is).

:func:`flash_mha` is the operator ``irsde::flash_mha``: it launches the
kernel on CUDA tensors and runs the plain version on CPU tensors.  It is
differentiable on both: the backward is :func:`flash_mha_backward`, the
gradient of the JAX package's ``_ref_mha`` (:func:`ref_mha_plain`) streamed
over blocks of ``BWD_BLOCK`` query rows, as ``_blocked_mha``'s
``lax.map`` over checkpointed blocks transposes to: peak extra memory
O(B·H·BWD_BLOCK·N), never N².  The forward saves q, k and v as they are
(strided views included, no copies).  The backward is a torch composition
(cuBLAS products and elementwise kernels), as the JAX package's backward is
no Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

FLASH_ATTN = kernels.Kernel(
    "irsde_flash_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    source="image_restoration_sde_tpu_torch/csrc/flash_attention.cu",
    replaces="image_restoration_sde_tpu/ops/flash_attention.py:64",
)

HEAD_DIMS = (64, 72)
# query rows per block of the streamed backward: of 256, 512, 1024 and
# 2048, the fastest at the DiT-L/2 train shape (8, 4096, 16, 64) in float32
# on an H100 whose buffers fit beside that train step at batch 8 (2048's
# 12.75 GiB would take the step past the card's 80 GB; chip_smoke.py's K4
# backward phase, PERF.md)
BWD_BLOCK = 1024
# keys per tile of the bfloat16 kernel, by head dim: where it rounds p
KEY_TILE = {64: 128, 72: 128}
# keys per tile of the float32 kernel: where its running max moves
F32_KEY_TILE = 32


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, N, H, D) attention, un-tiled: float32 scores and sums (float64
    for float64 inputs), ``p`` rounded to v's dtype before the product, the
    sum divided out last."""
    wide = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bihd,bjhd->bhij", q.to(wide), k.to(wide)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhij,bjhd->bhid", p.to(v.dtype).to(wide), v.to(wide)) / l
    return out.transpose(1, 2).to(q.dtype)


def ref_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, N, H, D) attention as the JAX package's ``_ref_mha``: float32
    scores, the softmax over the keys, ``p`` rounded to q's dtype, the
    product summed in float32 and rounded to q's dtype.  It divides before
    it rounds p, where :func:`flash_mha_plain` rounds first."""
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhij,bjhd->bihd", p.to(q.dtype).float(), v.float()).to(q.dtype)


def flash_mha_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, scale: float,
                       block: int = BWD_BLOCK) -> tuple:
    """The gradients (dq, dk, dv) of :func:`ref_mha_plain` at (q, k, v) for
    the output cotangent ``dout``, in q's dtype, streamed over blocks of
    ``block`` query rows.  Each block recomputes its (block x N) scores and
    softmax, writes its rows of dq and adds into float32 dk and dv; the
    block's float32 buffers (softmax, its gradient and, in bfloat16, the
    rounded p) are the only ones of size B·H·block·N.  The roundings are
    autograd's through :func:`ref_mha_plain`: p to q's dtype before the
    product with v, the gradient of that rounded p back to q's dtype, dq
    rounded once per block and dk, dv once at the end."""
    B, N, H, D = q.shape
    low = q.dtype != torch.float32

    def heads(t):  # (B, n, H, D) -> (B·H, n, D) float32
        return t.float().transpose(1, 2).reshape(B * H, -1, D)

    kf, vf = heads(k), heads(v)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    for i in range(0, N, block):
        qb, gb = heads(q[:, i : i + block]), heads(dout[:, i : i + block])
        p = torch.softmax(torch.bmm(qb, kf.transpose(1, 2)).mul_(scale), dim=-1)
        pc = p.to(q.dtype).float() if low else p
        dv.baddbmm_(pc.transpose(1, 2), gb)
        del pc
        dp = torch.bmm(gb, vf.transpose(1, 2))
        if low:
            dp = dp.to(q.dtype).float()
        ds = dp.mul_(p)  # the softmax's backward: p (dp - sum(p dp)), in place
        ds.sub_(p.mul_(ds.sum(dim=-1, keepdim=True)))
        del p
        dq[:, i : i + block] = (torch.bmm(ds, kf) * scale).view(B, H, -1, D).transpose(1, 2)
        dk.baddbmm_(ds.transpose(1, 2), qb, alpha=scale)
        del ds
    dk, dv = (t.view(B, H, N, D).transpose(1, 2).to(k.dtype) for t in (dk, dv))
    return dq, dk, dv


def flash_mha_tiled_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          block: int | None = None) -> torch.Tensor:
    """The same function in the kernel's order of operations: keys in tiles
    of ``block`` (by default the bfloat16 kernel's, ``KEY_TILE`` of the head
    dim, 128 where that has none), a running max and sum in
    float32, ``p`` rounded to v's dtype at the running max of its tile, the
    accumulator rescaled when a tile raises the max.  The kernel's results
    agree with this one to float32 rounding before the last rounding, where
    :func:`flash_mha_plain` rounds p at the row's final max instead."""
    if block is None:
        block = KEY_TILE.get(q.shape[-1], 128)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, H, N, D)
    m = torch.full(qf.shape[:-1] + (1,), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j in range(0, k.shape[1], block):
        s = qf @ kf[:, :, j : j + block].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vf[:, :, j : j + block]
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype)


def flash_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch K4 on CUDA tensors (B, N, H, D), float32 or bfloat16, D 64 or
    72, each with unit stride over D, stride D over H and batch and token
    strides that are multiples of 16 bytes; ``scale`` > 0.  Returns a
    contiguous tensor."""
    code = kernels.dtype_code(q.dtype)
    if not q.is_cuda:
        raise ValueError(f"flash_mha_cuda: q is on {q.device}, not a CUDA device")
    if q.dim() != 4:
        raise ValueError(f"flash_mha: q must be (B, N, H, D), not {tuple(q.shape)}")
    B, N, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_mha: head dim {D}; the kernel takes {HEAD_DIMS}")
    if not scale > 0:
        raise ValueError(f"flash_mha: scale {scale}; the kernel takes a positive scale")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_mha: {name} must be {q.dtype} {tuple(q.shape)} on {q.device}")
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"flash_mha: {name} must be contiguous over (H, D), strides {t.stride()}")
        if t.data_ptr() % 16 or (t.stride(0) * size) % 16 or (t.stride(1) * size) % 16:
            raise ValueError(f"flash_mha: {name} must be 16-byte aligned, with 16-byte batch and token strides")
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    if out.numel():
        FLASH_ATTN(kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(out),
                   q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                   B, N, H, D, scale, code, kernels.current_stream(q.device))
    return out


def _cuda(q, k, v, scale):
    return flash_mha_cuda(q, k, v, scale)


def _cpu(q, k, v, scale):
    return flash_mha_plain(q, k, v, scale).contiguous()


def _fake(q, k, v, scale):
    return q.new_empty(q.shape)


def _setup(ctx, inputs, output):
    q, k, v, ctx.scale = inputs
    ctx.save_for_backward(q, k, v)


def _backward(ctx, dout):
    return (*flash_mha_backward(*ctx.saved_tensors, dout, ctx.scale), None)


def flops(q_shape, k_shape, v_shape, scale, out_shape=None) -> int:
    """q k^T and p v: 2 B H Nq Nk D FLOP each."""
    B, Nq, H, D = q_shape
    return 4 * B * H * Nq * k_shape[1] * D


OP = kernels.define_op("flash_mha(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
                       cpu=_cpu, cuda=_cuda, fake=_fake, backward=_backward, setup_context=_setup, flops=flops)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, N, H, D) attention, softmax over the keys; differentiable (the
    streamed backward).  The kernel for CUDA tensors, the plain version for
    CPU tensors."""
    return OP(q, k, v, scale)
