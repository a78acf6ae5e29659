"""PyTorch port, CUDA kernels against their plain PyTorch versions.

Every test here needs the card (marker ``cuda``) and skips without one.
The module imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from image_restoration_sde_tpu_torch import ops
from image_restoration_sde_tpu_torch.ops import layernorm, linear_attention, naf_stack


def _bf16_bound(ref: np.ndarray) -> np.ndarray:
    """Per element: one bf16 ulp at its magnitude (both sides round a
    float32 value, either way) plus the float32 bound, 1e-5 of max|ref|
    (near-zero outputs are sums that cancel)."""
    mag = np.maximum(np.abs(ref.astype(np.float32)), 2.0**-126)
    return np.exp2(np.floor(np.log2(mag)) - 7) + 1e-5 * np.abs(ref).max()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# K1's (dtype, C, rows): the first sites, then every lane-group width (C/VEC
# a power of two or not: C = 96, 192, 320 bf16 mask lanes; f32 C = 1024
# takes 8 vectors a lane) at 1, 7 (rows not a multiple of a warp's), 1001
# and 131072 rows
LN_CASES = [(dtype, C, rows) for dtype in (torch.float32, torch.bfloat16)
            for C, rows in [(64, 4096), (128, 1001), (512, 999), (1024, 2048)]]
LN_CASES += [(torch.bfloat16, C, rows) for C in (8, 64, 96, 128, 192, 320, 512, 1024, 2048)
             for rows in (1, 7, 1001, 131072)]
LN_CASES += [(torch.float32, C, rows) for C in (4, 64, 96, 1024) for rows in (1, 7, 1001, 131072)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C,rows", LN_CASES, ids=str)
def test_layernorm_kernel_matches_plain(cuda_device, dtype, C, rows):
    """Bound: float32 1e-5 of max|y|; bfloat16 ``_bf16_bound`` (computed on
    the card: the largest cases hold 2.7e8 elements)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(rows, C, generator=gen, device=cuda_device) * 2 + 0.5).to(dtype)
    g = torch.randn(C, generator=gen, device=cuda_device) * 0.2 + 1
    eps = 1e-5 if dtype == torch.float32 else 1e-3
    launches = layernorm.LAYERNORM.launches
    y = layernorm.channel_layernorm(x, g, eps)
    assert layernorm.LAYERNORM.launches == launches + 1
    ref = layernorm.channel_layernorm_plain(x, g, eps).float()
    err = (y.float() - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5 * ref.abs().max().item()
    else:
        mag = ref.abs().clamp_min(2.0**-126)
        assert bool((err <= torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * mag.max()).all())


# K2's N, each at batch 3 but the deraining UNet's first level (batch 8)
# and the denoising 512 px request's (batch 1)
LA_BATCH = {16384: 8, 262144: 1}


def _ctx_float64(qkv: torch.Tensor) -> torch.Tensor:
    """K2a's function, ``linear_attention_ctx_plain``'s math in float64."""
    B, N, _ = qkv.shape
    x = qkv.double().reshape(B, N, 3, 4, 32)
    return torch.einsum("bnhd,bnhe->bhed", torch.softmax(x[:, :, 1], dim=1), x[:, :, 2] / N)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 36, 256, 1024, 4100, 16384, 262144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_linear_attention_kernels_match_plain(cuda_device, N, dtype):
    """TF32 off.  Bound: ctx and float32 outputs 1e-5 of max|ref|;
    bfloat16 outputs ``_bf16_bound``.  ctx is held against the float64
    composition at every N, and against the float32 plain version up to
    N = 16384 (beyond, the plain version's own float32 sums over N drift
    past that bound)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = (torch.randn(LA_BATCH.get(N, 3), N, 384, generator=gen, device=cuda_device) * 1.5).to(dtype)
    ctx = linear_attention.linear_attention_ctx_cuda(qkv)
    ctx_ref = linear_attention.linear_attention_ctx_plain(qkv)
    ref64 = _ctx_float64(qkv)
    assert (ctx.double() - ref64).abs().max().item() <= 1e-5 * ref64.abs().max().item()
    if N <= 16384:
        assert (ctx - ctx_ref).abs().max().item() <= 1e-5 * ctx_ref.abs().max().item()
    out = linear_attention.linear_attention_apply_cuda(qkv, ctx_ref)
    ref = linear_attention.linear_attention_apply_plain(qkv, ctx_ref)
    err = (out.float() - ref.float()).abs().cpu().numpy()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * ref.abs().max().item()
    else:
        assert (err <= _bf16_bound(ref.float().cpu().numpy())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 4100, 16384, 262144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_linear_attention_kernels_are_bit_equal_run_to_run(cuda_device, N, dtype):
    """Two runs of K2a and of K2b on the same input give the same bits:
    K2a combines its slices in a fixed order, whichever CTA ends first."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = (torch.randn(LA_BATCH.get(N, 3), N, 384, generator=gen, device=cuda_device) * 1.5).to(dtype)
    ctx = [linear_attention.linear_attention_ctx_cuda(qkv) for _ in range(2)]
    out = [linear_attention.linear_attention_apply_cuda(qkv, ctx[0]) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ctx[0], ctx[1]) and torch.equal(out[0], out[1])


@pytest.mark.cuda
def test_linear_attention_packed_gradient(cuda_device):
    """The packed op under autograd on the card: its forward launches K2a
    and K2b once each, its backward is the plain composition's, so the
    gradient equals the plain composition's within float32 1e-5 of
    max|grad|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    qkv = (torch.randn(2, 300, 384, generator=gen, device=cuda_device) * 1.5).requires_grad_()
    g = torch.randn(2, 300, 128, generator=gen, device=cuda_device)
    before = [linear_attention.LA_CTX.launches, linear_attention.LA_APPLY.launches]
    out = linear_attention.linear_attention_packed(qkv)
    assert [linear_attention.LA_CTX.launches, linear_attention.LA_APPLY.launches] == [b + 1 for b in before]
    (got,) = torch.autograd.grad(out, qkv, g)
    (want,) = torch.autograd.grad(linear_attention.linear_attention_packed_plain(qkv), qkv, g)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)], ids=str)
def test_flash_attention_gradient(cuda_device, dtype, bound):
    """K4 under autograd on the card, q, k, v strided views of one packed
    (B, N, 3, H, D) product (2, 1000, 3, 4, 64): one launch with a grad_fn;
    the backward launches none, and the gradient that reaches the packed
    tensor is ``flash_mha_backward``'s dq, dk, dv stacked, bit for bit
    (the backward is that function, on the saved views), and within
    ``bound`` of its max|grad| of autograd through the un-tiled
    ``ref_mha_plain`` (float32: sums in another order; bfloat16: the
    roundings of p and of its gradient, which a float32 difference may
    flip)."""
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    qkv = (torch.randn(2, 1000, 3, 4, 64, generator=gen, device=cuda_device) * 1.5).to(dtype).requires_grad_()
    g = torch.randn(2, 1000, 4, 64, generator=gen, device=cuda_device).to(dtype)
    before = FA.FLASH_ATTN.launches
    out = FA.flash_mha(*qkv.unbind(2), 0.125)
    assert FA.FLASH_ATTN.launches == before + 1 and out.grad_fn is not None
    (got,) = torch.autograd.grad(out, qkv, g)
    assert FA.FLASH_ATTN.launches == before + 1
    q, k, v = qkv.detach().unbind(2)
    assert torch.equal(got, torch.stack(FA.flash_mha_backward(q, k, v, g, 0.125), dim=2))
    (want,) = torch.autograd.grad(FA.ref_mha_plain(*qkv.unbind(2), 0.125), qkv, g)
    for i in range(3):
        a, b = got[:, :, i].float(), want[:, :, i].float()
        assert (a - b).abs().max().item() <= bound * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("C,rows", [(64, 65536), (128, 1001), (512, 2048), (1024, 512)], ids=str)
def test_layernorm_gradient(cuda_device, C, rows):
    """K1 under autograd on the card, float32: the forward launches K1 once
    and has a grad_fn; the gradients of x and g equal the plain
    composition's within 1e-5 of their max (the backward is that
    composition, on the kernel's saved inputs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    x = (torch.randn(rows, C, generator=gen, device=cuda_device) * 2 + 0.5).requires_grad_()
    g = (torch.randn(C, generator=gen, device=cuda_device) * 0.2 + 1).requires_grad_()
    cot = torch.randn(rows, C, generator=gen, device=cuda_device)
    before = layernorm.LAYERNORM.launches
    y = layernorm.channel_layernorm(x, g, 1e-5)
    assert layernorm.LAYERNORM.launches == before + 1 and y.grad_fn is not None
    got = torch.autograd.grad(y, (x, g), cot)
    assert layernorm.LAYERNORM.launches == before + 1  # the backward launches none
    want = torch.autograd.grad(layernorm.channel_layernorm_plain(x, g, 1e-5), (x, g), cot)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,K", [(3, 5, 7, 64, 4), (2, 8, 8, 512, 3)], ids=str)
def test_naf_stack_gradient(cuda_device, B, H, W, C, K):
    """K3 under autograd on the card, float32: one launch with a grad_fn;
    the gradients of x, temb and every block tensor equal plain autograd
    through ``naf_stack_plain`` within 1e-5 of each one's max (the backward
    recomputes that composition), and the backward launches nothing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(K)
    blocks = [{k: v.requires_grad_() for k, v in blk.items()} for blk in _naf_blocks(K, C, 4 * C // 8, cuda_device)]
    x = torch.randn(B, H, W, C, generator=gen, device=cuda_device).requires_grad_()
    temb = torch.randn(B, 4 * C // 8, generator=gen, device=cuda_device).requires_grad_()
    cot = torch.randn(B, H, W, C, generator=gen, device=cuda_device)
    inputs = [x, temb, *(v for blk in blocks for v in blk.values())]
    before = naf_stack.NAF_STACK.launches
    y = naf_stack.naf_stack(x, blocks, temb, 1e-5)
    assert naf_stack.NAF_STACK.launches == before + 1 and y.grad_fn is not None
    got = torch.autograd.grad(y, inputs, cot)
    assert naf_stack.NAF_STACK.launches == before + 1
    want = torch.autograd.grad(naf_stack.naf_stack_plain(x, naf_stack.stack_middle_params(blocks, temb), 1e-5),
                               inputs, cot)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("net_name", ["ConditionalUNet", "ConditionalNAFNet"])
def test_train_steps_kernel_path_match_plain_path(cuda_device, net_name):
    """Two train steps of a tiny net (UNet nf=16 depth 3; NAFNet width 16
    with a fused 4-block level), float32, Adam, the same weights, batches
    and generator on the kernel path and the plain path: each step's loss
    within 1e-4 of itself and the parameters after the steps elementwise
    within 2 lr (Adam's first step moves a near-zero gradient element by up
    to 2 lr when its sign differs)."""
    from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, ConditionalUNet, init_params_
    from image_restoration_sde_tpu_torch.sde import IRSDE
    from image_restoration_sde_tpu_torch.training import (build_from_options, build_lr_schedule, create_train_state,
                                                          make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_opt = {"optimizer": "Adam", "lr_G": 1e-4, "lr_scheme": "MultiStepLR", "lr_steps": [], "beta1": 0.9,
                 "beta2": 0.99}
    build = {"ConditionalUNet": lambda plain: ConditionalUNet(nf=16, depth=3, plain=plain),
             "ConditionalNAFNet": lambda plain: ConditionalNAFNet(width=16, enc_blk_nums=(1, 4), middle_blk_num=1,
                                                                  dec_blk_nums=(1, 1), plain=plain)}[net_name]
    sde = IRSDE.create(10, 100, "cosine", 0.005, device=cuda_device)
    batches = [tuple(torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(i + j)).to(cuda_device)
                     for j in range(2)) for i in range(0, 4, 2)]
    runs = {}
    state_dict = init_params_(build(False), torch.Generator().manual_seed(0)).state_dict()
    for plain in (False, True):
        net = build(plain).to(cuda_device)
        net.load_state_dict(state_dict)
        state = create_train_state(net, build_from_options(train_opt, net.parameters(), build_lr_schedule(train_opt)))
        step, gen = make_train_step(sde), torch.Generator(device=cuda_device).manual_seed(3)
        launches = sum(k.launches for k in ops.KERNELS)
        step_losses = [step(state, lq, gt, gen)[1]["loss"].item() for lq, gt in batches]
        assert (sum(k.launches for k in ops.KERNELS) > launches) == (not plain)
        runs[plain] = (step_losses, {k: v.detach().clone() for k, v in net.named_parameters()})
    for a, b in zip(runs[False][0], runs[True][0]):
        assert abs(a - b) <= 1e-4 * abs(b)
    for k, v in runs[True][1].items():
        assert (runs[False][1][k] - v).abs().max().item() <= 2 * train_opt["lr_G"], k


@pytest.mark.cuda
@pytest.mark.parametrize("N", [36, 256, 1024, 4100])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_per_slice_linear_attention_kernels_match_plain(cuda_device, N, d, dtype):
    """K5: one context and one apply launch per call.  TF32 off.  Bound:
    ctx and float32 outputs 1e-5 of max|ref|; bfloat16 outputs
    ``_bf16_bound`` (both sides compute in float32 from the same bf16
    inputs, then round)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(N + d)
    q, k, v = ((torch.randn(3, N, d, generator=gen, device=cuda_device) * 1.5).to(dtype) for _ in range(3))
    ctx = linear_attention.linear_attention_context_cuda(k, v)
    ctx_ref = linear_attention.linear_attention_context_plain(k, v)
    assert (ctx - ctx_ref).abs().max().item() <= 1e-5 * ctx_ref.abs().max().item()
    counted = (linear_attention.LIN_ATTN_CTX, linear_attention.LIN_ATTN_APPLY)
    before = [kk.launches for kk in counted]
    out = linear_attention.linear_attention(q, k, v)
    assert [kk.launches - b for kk, b in zip(counted, before)] == [1, 1]
    ref = linear_attention.linear_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - ref.float()).abs().cpu().numpy()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * ref.abs().max().item()
    else:
        assert (err <= _bf16_bound(ref.float().cpu().numpy())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_per_slice_linear_attention_kernels_are_bit_equal_run_to_run(cuda_device, d, dtype):
    """Two runs of K5's context and of its apply pass on the same input give
    the same bits: the context combines its slices in a fixed order."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 3)
    q, k, v = ((torch.randn(6, 4100, d, generator=gen, device=cuda_device) * 1.5).to(dtype) for _ in range(3))
    ctx = [linear_attention.linear_attention_context_cuda(k, v) for _ in range(2)]
    out = [linear_attention.linear_attention_apply_heads_cuda(q, ctx[0]) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ctx[0], ctx[1]) and torch.equal(out[0], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_per_slice_linear_attention_long_slice_against_float64(cuda_device, d, dtype):
    """K5 at BH = 1, N = 262144 (the slices and the combine at their
    longest).  ctx within 1e-5 of max|ctx| of the float64 composition (the
    plain float32 version's own sums over N drift there); the apply pass on
    that ctx within the bounds of the other K5 tests."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 4)
    q, k, v = ((torch.randn(1, 262144, d, generator=gen, device=cuda_device) * 1.5).to(dtype) for _ in range(3))
    ctx = linear_attention.linear_attention_context_cuda(k, v)
    ref64 = torch.einsum("bnd,bne->bde", torch.softmax(k.double(), dim=-2), v.double() / k.shape[-2])
    assert (ctx.double() - ref64).abs().max().item() <= 1e-5 * ref64.abs().max().item()
    ctx32 = ref64.float()
    out = linear_attention.linear_attention_apply_heads_cuda(q, ctx32)
    ref = linear_attention.linear_attention_apply_heads_plain(q, ctx32).float()
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5 * ref.abs().max().item()
    else:
        mag = ref.abs().clamp_min(2.0**-126)
        assert bool((err <= torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * mag.max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_per_slice_linear_attention_takes_unaligned_views(cuda_device, dtype):
    """K5 reads rows with 16-byte copies; a contiguous view whose data does
    not start on 16 bytes is copied first and gives the aligned result."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    flat = (torch.randn(3 * 2 * 300 * 32 + 1, generator=gen, device=cuda_device) * 1.5).to(dtype)
    q, k, v = flat[1:].view(3, 2, 300, 32)
    assert q.data_ptr() % 16 and q.is_contiguous()
    counted = (linear_attention.LIN_ATTN_CTX, linear_attention.LIN_ATTN_APPLY)
    before = [kk.launches for kk in counted]
    out = linear_attention.linear_attention(q, k, v)
    assert [kk.launches - b for kk, b in zip(counted, before)] == [1, 1]
    want = linear_attention.linear_attention(q.clone(), k.clone(), v.clone())
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_per_slice_linear_attention_gradient(cuda_device):
    """The op under autograd on the card: its forward launches K5, its
    backward is the plain composition's, so the gradients equal those of
    the plain composition within float32 1e-5 of max|grad|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ins = [torch.randn(4, 300, 32, generator=gen, device=cuda_device, requires_grad=True) for _ in range(3)]
    g = torch.randn(4, 300, 32, generator=gen, device=cuda_device)
    got = torch.autograd.grad(linear_attention.linear_attention(*ins), ins, g)
    want = torch.autograd.grad(linear_attention.linear_attention_plain(*ins), ins, g)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
def test_per_slice_linear_attention_refuses_what_it_does_not_take(cuda_device):
    q = torch.randn(2, 64, 32, device=cuda_device)
    with pytest.raises(ValueError, match="d in"):
        linear_attention.linear_attention(q[..., :24].contiguous(), q[..., :24].contiguous(), q[..., :24].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        linear_attention.linear_attention(q, q.transpose(0, 1).contiguous().transpose(0, 1), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        linear_attention.linear_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="share"):
        linear_attention.linear_attention(q, q[:, :32].contiguous(), q)
    with pytest.raises(ValueError, match="share"):
        linear_attention.linear_attention(q, q.bfloat16(), q)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randn(64, 32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        layernorm.channel_layernorm(x.t(), torch.ones(64, device=cuda_device), 1e-5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layernorm.channel_layernorm(x.half(), torch.ones(32, device=cuda_device), 1e-3)
    with pytest.raises(ValueError, match="dim_head"):
        linear_attention.linear_attention_packed(torch.randn(1, 8, 3 * 4 * 16, device=cuda_device), 4, 16)
    with pytest.raises(ValueError, match="heads"):
        linear_attention.linear_attention_packed(torch.randn(1, 8, 3 * 2 * 32, device=cuda_device), 2, 32)
    odd = torch.randn(8 * 384 + 1, device=cuda_device)[1:].view(1, 8, 384)
    with pytest.raises(ValueError, match="16-byte aligned"):
        linear_attention.linear_attention_ctx_cuda(odd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_net_kernel_path_matches_plain_path(cuda_device, dtype):
    """One ConditionalUNet(nf=8, depth=4) forward launches K1 18 times and
    K2a, K2b 9 times each.  TF32 off.  Bound: float32 1e-4 of max|out|
    (rounding differences through ~40 layers); bfloat16 twice the plain
    bf16 path's own distance from the float32 plain path."""
    from image_restoration_sde_tpu_torch.models import ConditionalUNet, init_params_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    nets = {}
    for key in ((dtype, False), (dtype, True), (torch.float32, True)):
        nets[key] = ConditionalUNet(nf=8, depth=4, dtype=key[0], plain=key[1])
        init_params_(nets[key], torch.Generator().manual_seed(0))
        nets[key].to(cuda_device).eval()
    x = torch.rand(2, 40, 36, 3, generator=gen).to(cuda_device)
    t = torch.tensor([5, 80], device=cuda_device)
    counts = [k.launches for k in (layernorm.LAYERNORM, linear_attention.LA_CTX, linear_attention.LA_APPLY)]
    with torch.inference_mode():
        got = nets[dtype, False](x, x * 0.5, t)
        ref = nets[dtype, True](x, x * 0.5, t)
        f32 = nets[torch.float32, True](x, x * 0.5, t)
    grew = [k.launches - c for k, c in zip((layernorm.LAYERNORM, linear_attention.LA_CTX, linear_attention.LA_APPLY), counts)]
    assert grew == [18, 9, 9]
    assert got.shape == (2, 40, 36, 3) and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * ref.abs().max().item()
    else:
        assert err <= 2 * (ref - f32).abs().max().item()


def _naf_blocks(K, C, T, device, seed=0):
    """K NAFBlocks' tensors in the reference key space: kernels with
    variance 1/fan_in, biases and residual scales ~0.1-0.2, gains ~1."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(device)

    blocks = []
    for _ in range(K):
        blocks.append({
            "conv1.weight": randn(2 * C, C, 1, 1, scale=C**-0.5), "conv1.bias": randn(2 * C, scale=0.1),
            "conv2.weight": randn(2 * C, 1, 3, 3, scale=1 / 3), "conv2.bias": randn(2 * C, scale=0.1),
            "sca.1.weight": randn(C, C, 1, 1, scale=C**-0.5), "sca.1.bias": randn(C, scale=0.1, shift=1.0),
            "conv3.weight": randn(C, C, 1, 1, scale=C**-0.5), "conv3.bias": randn(C, scale=0.1),
            "conv4.weight": randn(2 * C, C, 1, 1, scale=C**-0.5), "conv4.bias": randn(2 * C, scale=0.1),
            "conv5.weight": randn(C, C, 1, 1, scale=C**-0.5), "conv5.bias": randn(C, scale=0.1),
            "norm1.g": randn(1, C, 1, 1, scale=0.2, shift=1.0), "norm2.g": randn(1, C, 1, 1, scale=0.2, shift=1.0),
            "beta": randn(1, C, 1, 1, scale=0.2), "gamma": randn(1, C, 1, 1, scale=0.2),
            "mlp.1.weight": randn(4 * C, T // 2, scale=(T // 2) ** -0.5), "mlp.1.bias": randn(4 * C, scale=0.1),
        })
    return blocks


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,K", [(3, 5, 7, 64, 4), (2, 8, 8, 512, 3), (1, 12, 16, 128, 2)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_naf_stack_kernel_matches_plain(cuda_device, B, H, W, C, K, dtype):
    """One launch per call.  TF32 off.  Bound: float32 1e-4 of max|ref|
    (sums in another order through K blocks); bfloat16 twice the plain bf16
    result's distance from the plain float32 result (each block's output
    rounds to bf16, and a rounding that flips carries through the blocks)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    blocks = _naf_blocks(K, C, 64, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(B, H, W, C, generator=gen, device=cuda_device)
    temb = torch.randn(B, 64, generator=gen, device=cuda_device)
    eps = 1e-5 if dtype == torch.float32 else 1e-3
    launches = naf_stack.NAF_STACK.launches
    got = naf_stack.naf_stack(x.to(dtype), blocks, temb, eps)
    assert naf_stack.NAF_STACK.launches == launches + 1
    stacked = naf_stack.stack_middle_params(blocks, temb)
    ref = naf_stack.naf_stack_plain(x.to(dtype), stacked, eps)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape and torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * ref.abs().max().item()
    else:
        f32 = naf_stack.naf_stack_plain(x.to(dtype).float(), stacked, eps)
        assert err <= 2 * (ref.float() - f32).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,K", [(3, 5, 7, 64, 4), (2, 8, 8, 512, 3)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_naf_stack_kernel_rounds_each_block(cuda_device, B, H, W, C, K, dtype):
    """K blocks in one launch equal K chained one-block launches bit for
    bit (sums in a fixed order, grid sized without K), and each one-block
    launch is its plain version within float32 1e-5 of max|ref|, bfloat16
    ``_bf16_bound`` (one ulp): each block's output rounds to x's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    blocks = _naf_blocks(K, C, 64, cuda_device, seed=3)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(B, H, W, C, generator=gen, device=cuda_device).to(dtype)
    temb = torch.randn(B, 64, generator=gen, device=cuda_device)
    eps = 1e-5 if dtype == torch.float32 else 1e-3
    tmod = naf_stack.time_modulation(blocks, temb)
    stacked = naf_stack.stack_middle_params(blocks, temb)
    whole = naf_stack.naf_stack_cuda(x, blocks, tmod, eps)
    z = x
    for i in range(K):
        got = naf_stack.naf_stack_cuda(z, blocks[i : i + 1], tmod[i : i + 1], eps)
        ref = naf_stack.naf_stack_plain(z, {k: v[i : i + 1] for k, v in stacked.items()}, eps)
        err = (got.float() - ref.float()).abs().cpu().numpy()
        if dtype == torch.float32:
            assert err.max() <= 1e-5 * ref.abs().max().item()
        else:
            assert (err <= _bf16_bound(ref.float().cpu().numpy())).all()
        z = got
    assert torch.equal(z, whole)


@pytest.mark.cuda
def test_naf_stack_phase_times_stamp_every_barrier(cuda_device):
    """The timed launch gives the same bits as the plain launch, and one
    clock reading at the start, two around each of the 1 + 5K grid
    barriers and one at the end, in order."""
    K = 3
    blocks = _naf_blocks(K, 64, 64, cuda_device, seed=5)
    x = torch.randn(2, 8, 8, 64, generator=torch.Generator(device=cuda_device).manual_seed(6), device=cuda_device)
    tmod = naf_stack.time_modulation(blocks, torch.randn(2, 64, device=cuda_device))
    y, stamps = naf_stack.naf_stack_phase_times(x, blocks, tmod, 1e-5)
    assert torch.equal(y, naf_stack.naf_stack_cuda(x, blocks, tmod, 1e-5))
    assert stamps.shape == (2 + 2 * (1 + 5 * K),)
    assert (stamps[1:] >= stamps[:-1]).all() and stamps[0] > 0


@pytest.mark.cuda
def test_naf_stack_kernel_refuses_what_it_does_not_take(cuda_device):
    blocks = _naf_blocks(2, 64, 64, cuda_device)
    x = torch.randn(2, 4, 4, 64, device=cuda_device)
    tmod = naf_stack.time_modulation(blocks, torch.randn(2, 64, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        naf_stack.naf_stack_cuda(x.transpose(1, 2), blocks, tmod, 1e-5)
    with pytest.raises(ValueError, match="tmod"):
        naf_stack.naf_stack_cuda(x, blocks, tmod[:, :1], 1e-5)
    with pytest.raises(ValueError, match="float32"):
        naf_stack.naf_stack_cuda(x, [{**b, "conv1.weight": b["conv1.weight"].half()} for b in blocks], tmod, 1e-5)
    narrow = _naf_blocks(2, 60, 64, cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        naf_stack.naf_stack_cuda(torch.randn(2, 4, 4, 60, device=cuda_device), narrow,
                                 naf_stack.time_modulation(narrow, torch.randn(2, 64, device=cuda_device)), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_nafnet_kernel_path_matches_plain_path(cuda_device, dtype):
    """ConditionalNAFNet(width 16, enc (1, 4), mid 1, dec (1, 1)) on a
    ragged 22x30 input: the 4-block level launches K3 once, the 4 unfused
    blocks launch K1 twice each.  TF32 off.  Bounds as the UNet's."""
    from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, init_params_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(img_channel=4, width=16, enc_blk_nums=(1, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
    nets = {}
    for key in ((dtype, False), (dtype, True), (torch.float32, True)):
        nets[key] = ConditionalNAFNet(**cfg, dtype=key[0], plain=key[1])
        init_params_(nets[key], torch.Generator().manual_seed(0))
        nets[key].to(cuda_device).eval()
    x = torch.rand(2, 22, 30, 4, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    t = torch.tensor([5, 80], device=cuda_device)
    counted = (layernorm.LAYERNORM, naf_stack.NAF_STACK)
    counts = [k.launches for k in counted]
    with torch.inference_mode():
        got = nets[dtype, False](x, x * 0.5, t)
        grew = [k.launches - c for k, c in zip(counted, counts)]
        ref = nets[dtype, True](x, x * 0.5, t)
        f32 = nets[torch.float32, True](x, x * 0.5, t)
    assert grew == [8, 1]
    assert got.shape == (2, 22, 30, 4) and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * ref.abs().max().item()
    else:
        assert err <= 2 * (ref - f32).abs().max().item()


# ------------------------------------------------------------------ K4
FLASH_SHAPES = [(2, 4096, 16, 64), (1, 2816, 16, 64), (2, 1024, 16, 64), (1, 4096, 16, 72),
                (1, 1000, 16, 64), (3, 35, 4, 64)]


FLASH_FLIP_SHARE = 5e-4


def _flash_inputs(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device) * 1.5 for _ in range(3)]


def flash_bf16_agreement(got, tiled, q, k, v, scale):
    """bfloat16 attention against ``flash_mha_tiled_plain``, which rounds p
    where the kernel does: (share of elements past two bf16 ulps plus 1e-5
    of max|ref|, largest error over that bound plus one bf16 ulp of the
    row's largest p v term).  A float32 difference in s flips the rounding
    of a p now and then, and one flip moves an element by at most that last
    term; rounding p at the row max instead (``flash_mha_plain``) puts far
    more past two ulps (``chip_smoke.py`` phase 8 prints both shares).
    Pass: share <= FLASH_FLIP_SHARE and largest <= 1."""
    ref = tiled.float()
    mag = ref.abs().clamp_min(2.0**-126)
    tight = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * mag.max()
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    peak = torch.exp(s.amax(dim=-1) - s.logsumexp(dim=-1)).transpose(1, 2)[..., None]
    err = (got.float() - ref).abs()
    flip = 2.0**-7 * peak * v.float().abs().max()
    return (err > tight).float().mean().item(), (err / (tight + flip)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kernel_matches_plain(cuda_device, shape, dtype):
    """One launch per call.  TF32 off.  Bound: float32 1e-5 of max|ref|;
    bfloat16 twice the plain bf16 result's distance from the plain float32
    result on the same inputs (kernel and plain version round p at other
    maxima: the running one, the row's), and ``flash_bf16_agreement`` with
    the tiled plain version, which rounds p at the kernel's maxima."""
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (t.to(dtype) for t in _flash_inputs(shape, cuda_device, sum(shape)))
    scale = shape[-1] ** -0.5
    launches = FA.FLASH_ATTN.launches
    got = FA.flash_mha(q, k, v, scale)
    assert FA.FLASH_ATTN.launches == launches + 1
    ref = FA.flash_mha_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == shape and torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * ref.abs().max().item()
    else:
        f32 = FA.flash_mha_plain(q.float(), k.float(), v.float(), scale)
        assert err <= 2 * (ref.float() - f32).abs().max().item()
        del f32
        share, worst = flash_bf16_agreement(got, FA.flash_mha_tiled_plain(q, k, v, scale), q, k, v, scale)
        assert share <= FLASH_FLIP_SHARE and worst <= 1, (share, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kernel_takes_strided_qkv_views(cuda_device, D, dtype):
    """q, k, v as views of a packed (B, N, 3, H, D) product give the same
    bits as contiguous copies of them."""
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    B, N, H = 2, 300, 4
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = (torch.randn(B, N, 3, H, D, generator=gen, device=cuda_device) * 1.5).to(dtype)
    q, k, v = qkv.unbind(2)
    assert q.stride(1) == 3 * H * D
    got = FA.flash_mha(q, k, v, D**-0.5)
    want = FA.flash_mha(q.contiguous(), k.contiguous(), v.contiguous(), D**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_reused_buffers_anew(cuda_device):
    """The kernel keeps its TMA descriptors by pointer, shape and strides:
    new contents in the same buffers give the same bits as fresh copies."""
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    q, k, v = (t.bfloat16() for t in _flash_inputs((2, 300, 4, 64), cuda_device, 7))
    FA.flash_mha(q, k, v, 0.125)
    for t, seed in ((q, 8), (k, 9), (v, 10)):
        t.copy_(_flash_inputs((2, 300, 4, 64), cuda_device, seed)[0])
    got = FA.flash_mha(q, k, v, 0.125)
    want = FA.flash_mha(q.clone(), k.clone(), v.clone(), 0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    q = torch.randn(1, 64, 2, 64, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_mha(q.half(), q.half(), q.half(), 0.125)
    small = torch.randn(1, 64, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_mha(small, small, small, 0.125)
    swapped = q.transpose(1, 2).contiguous().transpose(1, 2)  # (B, N, H, D) with H outermost
    with pytest.raises(ValueError, match=r"contiguous over \(H, D\)"):
        FA.flash_mha(swapped, q, q, 0.125)
    odd = torch.randn(64 * 2 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(1, 64, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_mha(odd, odd, odd, 0.125)
    with pytest.raises(ValueError, match="must be"):
        FA.flash_mha(q, q[:, :32], q, 0.125)
    with pytest.raises(ValueError, match="positive scale"):
        FA.flash_mha(q, q, q, -0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_dit_kernel_path_matches_plain_path(cuda_device, dtype):
    """DiT(hidden 128, depth 2, heads 2: head dim 64) on a ragged 22x30
    latent (N = 165): one K4 launch per block.  Bounds as the UNet's."""
    from image_restoration_sde_tpu_torch.models import DiT, init_params_
    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(hidden_size=128, depth=2, num_heads=2, patch_size=2, in_channels=4)
    nets = {}
    for key in ((dtype, False), (dtype, True), (torch.float32, True)):
        nets[key] = DiT(**cfg, dtype=key[0], plain=key[1])
        init_params_(nets[key], torch.Generator().manual_seed(0))
        nets[key].to(cuda_device).eval()
    x = torch.randn(2, 22, 30, 4, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    t = torch.tensor([5, 80], device=cuda_device)
    launches = FLASH_ATTN.launches
    with torch.inference_mode():
        got = nets[dtype, False](x, x * 0.5, t)
        grew = FLASH_ATTN.launches - launches
        ref = nets[dtype, True](x, x * 0.5, t)
        f32 = nets[torch.float32, True](x, x * 0.5, t)
    assert grew == 2
    assert got.shape == (2, 22, 30, 4) and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * ref.abs().max().item()
    else:
        assert err <= 2 * (ref - f32).abs().max().item()


def _kernel_and_plain_nets(build, dtype, device):
    """The same seeded weights in the kernel path and the plain path at
    ``dtype``, and the plain path in float32."""
    from image_restoration_sde_tpu_torch.models import init_params_

    nets = {}
    for key in ((dtype, False), (dtype, True), (torch.float32, True)):
        nets[key] = build(dtype=key[0], plain=key[1])
        init_params_(nets[key], torch.Generator().manual_seed(0))
        nets[key].to(device).eval()
    return nets


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unconditional UNet", "stereo NAFNet", "bokeh NAFNet"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_new_nets_kernel_path_matches_plain_path(cuda_device, name, dtype):
    """The denoising UNet (nf 8, depth 4: 17 K1 and 8 K2a, K2b per
    forward, full attention in the mid block), the stereo NAFNet (width 16,
    enc (1, 4), mid 1, dec (1, 1): 4 K1 per block with its SCAM, no K3) and
    the bokeh NAFNet (the same levels: 2 K1 per block, no K3) on ragged
    inputs.  TF32 off.  Bounds as the UNet's."""
    import functools

    from image_restoration_sde_tpu_torch.models import BokehConditionalNAFNet, ConditionalUNet
    from image_restoration_sde_tpu_torch.models import StereoConditionalNAFNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    levels = dict(width=16, enc_blk_nums=(1, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
    gen = torch.Generator().manual_seed(1)
    t = torch.tensor([5, 80], device=cuda_device)
    if name == "unconditional UNet":
        build = functools.partial(ConditionalUNet, nf=8, depth=4, conditional=False)
        x = torch.rand(2, 40, 36, 3, generator=gen).to(cuda_device)
        args, want = (x, None, t), [17, 8, 8, 0]
    elif name == "stereo NAFNet":
        build = functools.partial(StereoConditionalNAFNet, **levels)
        x = torch.rand(2, 22, 30, 6, generator=gen).to(cuda_device)
        args, want = (x, x * 0.5, t), [4 * 8, 0, 0, 0]
    else:
        build = functools.partial(BokehConditionalNAFNet, img_channel=4, **levels)
        x = torch.rand(2, 22, 30, 4, generator=gen).to(cuda_device)
        lens = (torch.tensor([2.0, 8.0], device=cuda_device), torch.tensor([16.0, 1.4], device=cuda_device),
                torch.tensor([0.3, 0.9], device=cuda_device))
        args, want = (x, x * 0.5, t, lens), [2 * 8, 0, 0, 0]
    nets = _kernel_and_plain_nets(build, dtype, cuda_device)
    counted = (layernorm.LAYERNORM, linear_attention.LA_CTX, linear_attention.LA_APPLY, naf_stack.NAF_STACK)
    counts = [k.launches for k in counted]
    with torch.inference_mode():
        got = nets[dtype, False](*args)
        grew = [k.launches - c for k, c in zip(counted, counts)]
        ref = nets[dtype, True](*args)
        f32 = nets[torch.float32, True](*args)
    assert grew == want
    assert got.shape == x.shape and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * ref.abs().max().item()
    else:
        assert err <= 2 * (ref - f32).abs().max().item()


@pytest.mark.cuda
def test_test_entry_point_on_the_card(cuda_device, tmp_path):
    """``python -m image_restoration_sde_tpu_torch.test`` on a tiny deraining
    YAML (UNet nf 8 depth 2, 3 sde steps, two LQ/GT pairs of odd sizes) on
    the card: exactly 3 x (10 K1, 5 K2a, 5 K2b) launches an image, finite
    metrics, the output PNGs, and the same YAML's plain path within 2
    levels of 255 of the kernel path's outputs (TF32 off; the two
    paths draw the same noise)."""
    from image_restoration_sde_tpu_torch import runners, test
    from image_restoration_sde_tpu_torch.data.io_utils import read_img_uint8
    from image_restoration_sde_tpu_torch.data.synthetic import write_pairs
    from image_restoration_sde_tpu_torch.utils import options

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = write_pairs(str(tmp_path / "data"), 2, seed=1, min_size=37, max_size=61)
    ymls = {}
    for plain in (False, True):
        ymls[plain] = str(tmp_path / f"{plain}.yml")
        with open(ymls[plain], "w") as f:
            f.write(f"""name: tiny
model: denoising
distortion: derain
sde: {{max_sigma: 10, T: 100, schedule: cosine, eps: 0.005, sample_T: 3, sampling_mode: sde}}
degradation: {{sigma: 25, noise_type: G, scale: 4}}
datasets:
  test1: {{name: pairs, mode: LQGT, dataroot_GT: {data}/GT, dataroot_LQ: {data}/LQ}}
network_G: {{which_model_G: ConditionalUNet, setting: {{in_nc: 3, out_nc: 3, nf: 8, depth: 2, plain: {plain}}}}}
path: {{root: {tmp_path}/{plain}, pretrain_model_G: {tmp_path}/net.pth}}
""")
    opt = options.dict_to_nonedict(options.parse(ymls[False], is_train=False))
    opt["path"]["pretrain_model_G"] = None
    torch.save(runners.build_task(opt, 3, "cpu").net.state_dict(), tmp_path / "net.pth")
    counted = (layernorm.LAYERNORM, linear_attention.LA_CTX, linear_attention.LA_APPLY, naf_stack.NAF_STACK)
    counts = [k.launches for k in counted]
    result = test.evaluate(ymls[False], "cuda")["pairs"]
    assert [k.launches - c for k, c in zip(counted, counts)] == [2 * 3 * 10, 2 * 3 * 5, 2 * 3 * 5, 0]
    assert len(result["images"]) == 2 and np.isfinite(result["psnr"]) and result["peak_memory_bytes"] > 0
    assert result["held_memory_bytes"] > 0  # the net's weights, on the card before the set began
    test.evaluate(ymls[True], "cuda")
    assert [k.launches - c for k, c in zip(counted, counts)] == [2 * 3 * 10, 2 * 3 * 5, 2 * 3 * 5, 0]
    outs = {plain: sorted(tmp_path.glob(f"{plain}/results/*/tiny/pairs/????.png")) for plain in (False, True)}
    assert len(outs[False]) == 2 and [p.name for p in outs[False]] == [p.name for p in outs[True]]
    for a, b in zip(outs[False], outs[True]):
        assert np.abs(read_img_uint8(str(a)).astype(int) - read_img_uint8(str(b)).astype(int)).max() <= 2
