"""PyTorch port, CUDA kernels against their plain PyTorch versions.

Every test here needs the card (marker ``cuda``) and skips without one.
The module imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from image_restoration_sde_tpu_torch.ops import layernorm, linear_attention


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


@pytest.mark.cuda
@pytest.mark.parametrize("C,rows", [(64, 4096), (128, 1001), (512, 999), (1024, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_layernorm_kernel_matches_plain(cuda_device, C, rows, dtype):
    """Bound: float32 1e-5 of max|y|; bfloat16 ``_bf16_bound``."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(rows, C, generator=gen, device=cuda_device) * 2 + 0.5).to(dtype)
    g = torch.randn(C, generator=gen, device=cuda_device) * 0.2 + 1
    eps = 1e-5 if dtype == torch.float32 else 1e-3
    launches = layernorm.LAYERNORM.launches
    y = layernorm.channel_layernorm(x, g, eps)
    assert layernorm.LAYERNORM.launches == launches + 1
    ref = layernorm.channel_layernorm_plain(x, g, eps)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().cpu().numpy()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * ref.abs().max().item()
    else:
        assert (err <= _bf16_bound(ref.float().cpu().numpy())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [36, 256, 1024, 4100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_linear_attention_kernels_match_plain(cuda_device, N, dtype):
    """TF32 off.  Bound: ctx and float32 outputs 1e-5 of max|ref|;
    bfloat16 outputs ``_bf16_bound``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = (torch.randn(3, N, 384, generator=gen, device=cuda_device) * 1.5).to(dtype)
    ctx = linear_attention.linear_attention_ctx_cuda(qkv)
    ctx_ref = linear_attention.linear_attention_ctx_plain(qkv)
    assert (ctx - ctx_ref).abs().max().item() <= 1e-5 * ctx_ref.abs().max().item()
    out = linear_attention.linear_attention_apply_cuda(qkv, ctx_ref)
    ref = linear_attention.linear_attention_apply_plain(qkv, ctx_ref)
    err = (out.float() - ref.float()).abs().cpu().numpy()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * ref.abs().max().item()
    else:
        assert (err <= _bf16_bound(ref.float().cpu().numpy())).all()


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randn(64, 32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        layernorm.channel_layernorm(x.t(), torch.ones(64, device=cuda_device), 1e-5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layernorm.channel_layernorm(x.half(), torch.ones(32, device=cuda_device), 1e-3)
    with pytest.raises(ValueError, match="dim_head"):
        linear_attention.linear_attention_packed(torch.randn(1, 8, 3 * 4 * 16, device=cuda_device), 4, 16)


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
