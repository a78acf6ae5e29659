"""PyTorch port, kernel ops: the plain versions of K1 (channel LayerNorm)
and K2 (packed linear attention) held against the JAX package's Pallas
kernels in interpret mode; dispatch on the CPU; import hygiene.  The CUDA
kernels themselves are tested in test_torch_cuda.py."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.ops.layernorm import channel_layernorm as j_channel_layernorm
from image_restoration_sde_tpu.ops.linear_attention import _jnp_packed, _pallas_packed
from image_restoration_sde_tpu.ops.linear_attention import linear_attention_packed as j_linear_attention_packed
from image_restoration_sde_tpu_torch.ops import KERNELS, layernorm, linear_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each element's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(ref.astype(np.float32)), 2.0**-126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _bf16_bound(ref: np.ndarray) -> np.ndarray:
    """Per element: one bf16 ulp (the two sides may round a float32 value
    either way) plus the float32 bound, 1e-5 of max|ref| (near-zero outputs
    are sums that cancel, where float32 differences exceed their ulp)."""
    return _bf16_ulp(ref) + 1e-5 * np.abs(ref).max()


def _to_jax(x: np.ndarray, dtype):
    return jnp.asarray(x).astype(dtype)


def _to_torch(x: np.ndarray, dtype):
    return torch.from_numpy(x).to(dtype)


# ------------------------------------------------------------------ K1
LN_SHAPES = [(2, 9, 7, 48), (3, 5, 64), (1001, 128), (7, 1024)]  # odd row counts


@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_plain_matches_pallas_interpret(shape, dtype):
    """Bound: float32 1e-5 absolute on O(1) outputs (the Pallas kernel takes
    E[x^2] - mean^2, the port the centered variance: both are float32
    rounding apart on these rows); bfloat16 per element one bf16 ulp plus
    the float32 bound, relative (``_bf16_bound``)."""
    r = np.random.default_rng(0)
    x = (r.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    g = (r.standard_normal(shape[-1]) * 0.2 + 1).astype(np.float32)
    eps = 1e-5 if dtype == "float32" else 1e-3
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jax.jit(lambda a, b: j_channel_layernorm(a, b, eps, True, True))(_to_jax(x, jd), jnp.asarray(g))
    got = layernorm.channel_layernorm(_to_torch(x, td), torch.from_numpy(g), eps)
    assert got.dtype == td and got.shape == shape
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert err.max() <= 1e-5
    else:
        assert (err <= _bf16_bound(want)).all()


def test_layernorm_centered_variance_on_large_mean_rows():
    """Rows with mean 1000 and std 1: the port's centered variance stays
    within 1e-4 of the float64 answer (E[x^2] - mean^2 in float32 rounds
    x^2 ~ 1e6 to ~0.06, which is several percent of var = 1)."""
    r = np.random.default_rng(1)
    x = (r.standard_normal((64, 256)) + 1000).astype(np.float32)
    g = np.ones(256, np.float32)
    x64 = x.astype(np.float64)
    want = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-5)
    got = layernorm.channel_layernorm_plain(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
    assert np.abs(got.numpy() - want).max() <= 1e-4


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("N", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_attention_plain_matches_pallas_interpret(N, dtype):
    """Bound: float32 1e-5 of max|ref| (sums over N and d run in another
    order; outputs are O(1/N^1.5)); bfloat16 per element one bf16 ulp plus
    that float32 bound (``_bf16_bound``): both sides compute in float32
    from the same bf16 inputs, then round."""
    r = np.random.default_rng(2)
    qkv = (r.standard_normal((2, N, 384)) * 1.5).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jax.jit(lambda t: _pallas_packed(t, 32, interpret=True))(_to_jax(qkv, jd))
    got = linear_attention.linear_attention_packed(_to_torch(qkv, td), 4, 32)
    assert got.dtype == td and got.shape == (2, N, 128)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert err.max() <= 1e-5 * np.abs(want).max()
    else:
        assert (err <= _bf16_bound(want)).all()


def test_linear_attention_outlier_head_no_nan():
    """A head whose q-logits sit ~120 above the others: the per-head
    softmax shift keeps every head finite.  Bound as the JAX test: 1e-4
    relative to max|ref|."""
    r = np.random.default_rng(11)
    qkv = r.standard_normal((1, 256, 384)).astype(np.float32)
    qkv[:, :, :32] += 120.0
    ref = np.asarray(_jnp_packed(jnp.asarray(qkv), 4, 32))
    pallas = np.asarray(jax.jit(lambda t: _pallas_packed(t, 32, interpret=True))(jnp.asarray(qkv)))
    got = linear_attention.linear_attention_packed(torch.from_numpy(qkv)).numpy()
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-4
    assert np.abs(got - pallas).max() / scale < 1e-4


def test_linear_attention_packed_gradient_matches_jax():
    """float32, B = 2, N = 64: the gradient of sum(out * w) through the
    port's op (its autograd.Function's backward) against ``jax.grad``
    through the JAX op's custom_vjp.  Bound 1e-5 of max|grad|: both
    differentiate a float32 composition of the same function, with sums in
    another order."""
    r = np.random.default_rng(12)
    qkv = (r.standard_normal((2, 64, 384)) * 1.5).astype(np.float32)
    w = r.standard_normal((2, 64, 128)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(j_linear_attention_packed(t, 4, 32) * w)))(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_()
    (linear_attention.linear_attention_packed(x, 4, 32) * torch.from_numpy(w)).sum().backward()
    assert x.grad.shape == qkv.shape
    assert np.abs(x.grad.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_linear_attention_ctx_layout():
    """ctx is [b, h, e, d] = sum_n softmax_N(k)[n, d] v[n, e] / N, checked
    against a float64 numpy evaluation (bound 1e-5 of max|ctx|, float32)."""
    r = np.random.default_rng(3)
    qkv = r.standard_normal((2, 40, 384)).astype(np.float32)
    k = qkv[:, :, 128:256].reshape(2, 40, 4, 32).astype(np.float64)
    v = qkv[:, :, 256:].reshape(2, 40, 4, 32).astype(np.float64)
    ks = np.exp(k - k.max(1, keepdims=True))
    ks /= ks.sum(1, keepdims=True)
    want = np.einsum("bnhd,bnhe->bhed", ks, v) / 40
    got = linear_attention.linear_attention_ctx_plain(torch.from_numpy(qkv))
    assert got.shape == (2, 4, 32, 32) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ----------------------------------------------------- dispatch on the CPU
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = [k.launches for k in KERNELS]
    x = torch.randn(10, 64)
    g = torch.ones(64)
    assert torch.equal(layernorm.channel_layernorm(x, g, 1e-5), layernorm.channel_layernorm_plain(x, g, 1e-5))
    qkv = torch.randn(2, 20, 384)
    assert torch.equal(linear_attention.linear_attention_packed(qkv),
                       linear_attention.linear_attention_packed_plain(qkv))
    assert [k.launches for k in KERNELS] == before


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        layernorm.channel_layernorm_cuda(torch.randn(4, 64), torch.ones(64), 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        linear_attention.linear_attention_ctx_cuda(torch.randn(1, 8, 384))


def test_import_builds_nothing_and_imports_no_jax_or_triton():
    code = (
        "import sys; before = set(sys.modules)\n"
        "import image_restoration_sde_tpu_torch as p\n"
        "from image_restoration_sde_tpu_torch import kernels, models, ops, sampling, sde, utils\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton', 'image_restoration_sde_tpu'))\n"
        "assert not bad, bad\n"
        "assert kernels.load_library.cache_info().currsize == 0\n"
        "print('ok')\n"
    )
    build_before = sorted(os.listdir(os.path.join(REPO, "image_restoration_sde_tpu_torch", "_build"))) \
        if os.path.isdir(os.path.join(REPO, "image_restoration_sde_tpu_torch", "_build")) else None
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    build_after = sorted(os.listdir(os.path.join(REPO, "image_restoration_sde_tpu_torch", "_build"))) \
        if os.path.isdir(os.path.join(REPO, "image_restoration_sde_tpu_torch", "_build")) else None
    assert build_after == build_before
