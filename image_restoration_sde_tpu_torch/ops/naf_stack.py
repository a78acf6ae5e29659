"""Fused NAFBlock stack: CUDA kernel K3 and its plain PyTorch version.

Counterpart of ``image_restoration_sde_tpu/ops/naf_stack.py``: K NAFBlocks
run back to back on an NHWC activation ``x`` (B, H, W, C), all math in
float32 with float32 weights, the output of each block rounded to
``x.dtype`` before the next.  The time modulation ``tmod`` (K, B, 4C) is
computed outside, by :func:`time_modulation`.  The kernel is
``csrc/naf_stack.cu``: one launch per call.

A block's parameters are a mapping in the reference torch key space of one
``NAFBlock`` (``conv1.weight``, ``sca.1.bias``, ``norm1.g``, ``beta``, ...).
The kernel reads them in place through a device table of pointers;
:func:`stack_middle_params` builds the stacked (K, ...) layout of the JAX
package, which only the plain version and the tests use.

:func:`naf_stack` computes ``tmod`` and calls the operator
``irsde::naf_stack(x, tmod, eps, tensors)`` (every block's tensors in
``PARAM_ORDER``), which launches the kernel on a CUDA tensor and runs the
plain version on a CPU tensor.  It is differentiable: the operator's
backward recomputes the plain version from the saved ``x``, ``tmod`` and
block tensors, as the JAX op's custom_vjp does; the gradient of ``temb``
flows through :func:`time_modulation`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, Sequence

import torch

from .. import kernels

NAF_STACK = kernels.Kernel(
    "irsde_naf_stack",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    source="image_restoration_sde_tpu_torch/csrc/naf_stack.cu",
    replaces="image_restoration_sde_tpu/ops/naf_stack.py:104",
)

# the kernel takes C a multiple of this (csrc/naf_stack.cu)
CHANNEL_MULTIPLE = 8

# the kernel's per-block pointer table, in csrc/naf_stack.cu's order
PARAM_ORDER = (
    "conv1.weight", "conv1.bias", "conv2.weight", "conv2.bias", "sca.1.weight", "sca.1.bias",
    "conv3.weight", "conv3.bias", "conv4.weight", "conv4.bias", "conv5.weight", "conv5.bias",
    "norm1.g", "norm2.g", "beta", "gamma",
)
WEIGHT_KEYS = (
    "w1", "b1", "wdw", "b2", "wsca", "bsca", "w3", "b3",
    "w4", "b4", "w5", "b5", "g1", "g2", "beta", "gamma", "tmod",
)

Block = Mapping[str, torch.Tensor]


def _gate(x: torch.Tensor) -> torch.Tensor:
    """SimpleGate over the trailing axis."""
    x1, x2 = x.chunk(2, dim=-1)
    return x1 * x2


def time_modulation(blocks: Sequence[Block], temb: torch.Tensor) -> torch.Tensor:
    """(K, B, 4C) float32: each block's ``SimpleGate(temb) @ mlp.1.weight.T
    + mlp.1.bias``, for all K blocks in one batched product."""
    tg = _gate(temb.float())
    w = torch.stack([b["mlp.1.weight"] for b in blocks]).float()  # (K, 4C, T/2)
    bias = torch.stack([b["mlp.1.bias"] for b in blocks]).float()  # (K, 4C)
    return torch.matmul(tg, w.transpose(1, 2)) + bias[:, None, :]


def stack_middle_params(blocks: Sequence[Block], temb: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked layout, float32: 1x1 kernels (K, in, out),
    the depthwise kernel (K, 3, 3, 2C), vectors (K, 1, D), ``tmod`` (K, B, 4C)."""
    return stack_params(blocks, time_modulation(blocks, temb))


def stack_params(blocks: Sequence[Block], tmod: torch.Tensor) -> Dict[str, torch.Tensor]:
    """:func:`stack_middle_params` with the time modulation (K, B, 4C) given."""

    def dense(k):  # (out, in, 1, 1) -> (in, out)
        return torch.stack([b[k].reshape(b[k].shape[0], -1).t() for b in blocks]).float()

    def vec(k):
        return torch.stack([b[k].reshape(1, -1) for b in blocks]).float()

    return {
        "w1": dense("conv1.weight"), "b1": vec("conv1.bias"),
        "wdw": torch.stack([b["conv2.weight"][:, 0].permute(1, 2, 0) for b in blocks]).float(),
        "b2": vec("conv2.bias"),
        "wsca": dense("sca.1.weight"), "bsca": vec("sca.1.bias"),
        "w3": dense("conv3.weight"), "b3": vec("conv3.bias"),
        "w4": dense("conv4.weight"), "b4": vec("conv4.bias"),
        "w5": dense("conv5.weight"), "b5": vec("conv5.bias"),
        "g1": vec("norm1.g"), "g2": vec("norm2.g"), "beta": vec("beta"), "gamma": vec("gamma"),
        "tmod": tmod.float(),
    }


def _norm(z: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    mean = z.mean(-1, keepdim=True)
    var = (z - mean).square().mean(-1, keepdim=True)  # centered, as K1
    return (z - mean) * torch.rsqrt(var + eps) * g


def _block_math(x: torch.Tensor, w: Mapping[str, torch.Tensor], eps: float) -> torch.Tensor:
    """One NAFBlock on x (B, H, W, C), float32 math, this block's weights."""
    H, W = x.shape[1], x.shape[2]
    shift_att, scale_att, shift_ffn, scale_ffn = (t[:, None, None, :] for t in w["tmod"].chunk(4, dim=-1))
    inp = x.float()
    h = _norm(inp, w["g1"], eps) * (scale_att + 1.0) + shift_att
    h = h @ w["w1"] + w["b1"]
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1))  # zero padding
    acc = torch.zeros_like(h)
    for dh in range(3):
        for dw in range(3):
            acc = acc + hp[:, dh : dh + H, dw : dw + W, :] * w["wdw"][dh, dw]
    h = _gate(acc + w["b2"])
    pooled = h.mean(dim=(1, 2), keepdim=True)
    h = h * (pooled @ w["wsca"] + w["bsca"])
    h = h @ w["w3"] + w["b3"]
    y = inp + h * w["beta"]

    h = _norm(y, w["g2"], eps) * (scale_ffn + 1.0) + shift_ffn
    h = _gate(h @ w["w4"] + w["b4"])
    h = h @ w["w5"] + w["b5"]
    return y + h * w["gamma"]


def naf_stack_plain(x: torch.Tensor, stacked: Mapping[str, torch.Tensor], eps: float) -> torch.Tensor:
    """K blocks on x (B, H, W, C); each block's output rounded to x.dtype."""
    for i in range(stacked["w1"].shape[0]):
        x = _block_math(x, {k: stacked[k][i] for k in WEIGHT_KEYS}, eps).to(x.dtype)
    return x


@functools.lru_cache(maxsize=8)
def _pointer_table(device: torch.device, ptrs: tuple) -> torch.Tensor:
    return torch.tensor(ptrs, dtype=torch.int64).to(device)


def _block_tensors(blocks: Sequence[Block], x: torch.Tensor) -> tuple:
    """Data pointers of every block's tensors, in PARAM_ORDER; each must be
    a contiguous float32 tensor of its shape on x's device."""
    C = x.shape[-1]
    numel = {"conv1.weight": 2 * C * C, "conv1.bias": 2 * C, "conv2.weight": 18 * C,
             "conv2.bias": 2 * C, "sca.1.weight": C * C, "conv4.weight": 2 * C * C,
             "conv4.bias": 2 * C, "conv3.weight": C * C, "conv5.weight": C * C}
    ptrs = []
    for i, blk in enumerate(blocks):
        for k in PARAM_ORDER:
            t = blk[k]
            if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
                raise ValueError(f"naf_stack: block {i} {k} must be a contiguous float32 tensor on {x.device}")
            if t.numel() != numel.get(k, C):
                raise ValueError(f"naf_stack: block {i} {k} has {t.numel()} entries for C={C}")
            ptrs.append(t.data_ptr())
    return tuple(ptrs)


def naf_stack_cuda(x: torch.Tensor, blocks: Sequence[Block], tmod: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch K3 on a contiguous CUDA tensor x (B, H, W, C), float32 or
    bfloat16, C a multiple of 8; ``tmod`` float32 (K, B, 4C)."""
    return _launch(x, blocks, tmod, eps, None)


def naf_stack_phase_times(x: torch.Tensor, blocks: Sequence[Block], tmod: torch.Tensor, eps: float) -> tuple:
    """One K3 launch as :func:`naf_stack_cuda`, its first CTA reading the
    card's clock around every grid barrier.  Returns (output, stamps): the
    int64 nanosecond readings, on the host, in the kernel's order (start;
    before and after each barrier: two opening barriers, then five per
    block, four in the last; end)."""
    stamps = torch.zeros(kernels.load_library().irsde_naf_stack_stamps(len(blocks)), dtype=torch.int64,
                         device=x.device)
    y = _launch(x, blocks, tmod, eps, stamps)
    return y, stamps.cpu()


def _launch(x, blocks, tmod, eps, stamps):
    code = kernels.dtype_code(x.dtype)
    if not x.is_cuda:
        raise ValueError(f"naf_stack_cuda: x is on {x.device}, not a CUDA device")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("naf_stack: x must be a contiguous (B, H, W, C) tensor")
    B, H, W, C = x.shape
    if C % CHANNEL_MULTIPLE:
        raise ValueError(f"naf_stack: C={C}; the kernel takes a multiple of {CHANNEL_MULTIPLE} channels")
    K = len(blocks)
    if K == 0:
        raise ValueError("naf_stack: no blocks")
    if tmod.shape != (K, B, 4 * C) or tmod.dtype != torch.float32 or tmod.device != x.device \
            or not tmod.is_contiguous():
        raise ValueError(f"naf_stack: tmod must be contiguous float32 {(K, B, 4 * C)} on {x.device}")
    table = _pointer_table(x.device, _block_tensors(blocks, x))
    ws = torch.empty(kernels.load_library().irsde_naf_stack_workspace(B, H, W, C),
                     dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    NAF_STACK(kernels.ptr(x), kernels.ptr(y), kernels.ptr(tmod), kernels.ptr(table), kernels.ptr(ws),
              B, H, W, C, K, eps, code, None if stamps is None else kernels.ptr(stamps),
              kernels.current_stream(x.device))
    return y


def _unflatten(tensors: Sequence[torch.Tensor]) -> list:
    """A flat sequence of K blocks' tensors, each block's in PARAM_ORDER ->
    K block mappings."""
    n = len(PARAM_ORDER)
    return [dict(zip(PARAM_ORDER, tensors[i : i + n])) for i in range(0, len(tensors), n)]


def naf_stack_flat_plain(x, tmod, eps, tensors):
    """:func:`naf_stack_plain` on the operator's arguments."""
    return naf_stack_plain(x, stack_params(_unflatten(tensors), tmod), eps)


def _cuda(x, tmod, eps, tensors):
    return naf_stack_cuda(x, _unflatten(tensors), tmod, eps)


def _cpu(x, tmod, eps, tensors):
    return naf_stack_flat_plain(x, tmod, eps, tensors).contiguous()


def _fake(x, tmod, eps, tensors):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _setup(ctx, inputs, output):
    x, tmod, ctx.eps, tensors = inputs
    ctx.save_for_backward(x, tmod, *tensors)


def _backward(ctx, grad):
    def plain(x, tmod, *tensors):
        return naf_stack_flat_plain(x, tmod, ctx.eps, tensors)

    grads = kernels.plain_grads(plain, ctx.saved_tensors, grad)
    return grads[0], grads[1], None, list(grads[2:])


def flops(x_shape, tmod_shape, eps, tensor_shapes, out_shape=None) -> int:
    """Per pixel and block the four 1x1 products (12 C^2), the depthwise
    conv (36 C), norms, gates and residuals (~30 C); per sample and block
    the SCA product (2 C^2)."""
    B, H, W, C = x_shape
    K = len(tensor_shapes) // len(PARAM_ORDER)
    return K * (B * H * W * (12 * C * C + 36 * C + 30 * C) + B * 2 * C * C)


OP = kernels.define_op("naf_stack(Tensor x, Tensor tmod, float eps, Tensor[] tensors) -> Tensor",
                       cpu=_cpu, cuda=_cuda, fake=_fake, backward=_backward, setup_context=_setup, flops=flops)


def naf_stack(x: torch.Tensor, blocks: Sequence[Block], temb: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """K NAFBlocks on x (B, H, W, C) with time embedding ``temb`` (B, T);
    differentiable in x, temb and every block tensor.  The kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    tensors = [blk[k] for blk in blocks for k in PARAM_ORDER]
    return OP(x, time_modulation(blocks, temb), eps, tensors)
