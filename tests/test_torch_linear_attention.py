"""PyTorch port, the per-slice linear attention op (kernel K5): its plain
version held against the JAX package's two Pallas kernels in interpret mode
(the resident ``_pallas_linear_attention`` and the N-tiled
``_pallas_linear_attention_streaming``: the JAX op's own test at N = 64
never reaches either), its gradients against the JAX op's, an outlier
case, and dispatch on the CPU.  The CUDA kernels are tested in
test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.ops.linear_attention import (
    _jnp_linear_attention,
    _pallas_linear_attention,
    _pallas_linear_attention_streaming,
)
from image_restoration_sde_tpu.ops.linear_attention import linear_attention as j_linear_attention
from image_restoration_sde_tpu_torch.ops import KERNELS
from image_restoration_sde_tpu_torch.ops import linear_attention as LA
from test_torch_ops import _bf16_bound


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(shape) * 1.5).astype(np.float32) for _ in range(3)]


def _types(dtype):
    return (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)


def _check(got: torch.Tensor, want, dtype):
    """float32: 1e-5 of max|ref| (sums over N and d in another order);
    bfloat16: per element one bf16 ulp plus that float32 bound
    (``_bf16_bound``): both sides compute in float32 from the same bf16
    inputs, then round."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert err.max() <= 1e-5 * np.abs(want).max()
    else:
        assert (err <= _bf16_bound(want)).all()


@pytest.mark.parametrize("N,d", [(128, 32), (1024, 32), (128, 16), (128, 64)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_resident_pallas_kernel_interpret(N, d, dtype):
    """K5a's regime: N * d * 4 <= 1 MiB and N % 128 == 0."""
    jd, td = _types(dtype)
    q, k, v = _inputs((3, N, d), seed=N + d)
    want = jax.jit(lambda a, b, c: _pallas_linear_attention(a, b, c, interpret=True))(
        *(jnp.asarray(t).astype(jd) for t in (q, k, v)))
    got = LA.linear_attention(*(torch.from_numpy(t).to(td) for t in (q, k, v)))
    assert got.dtype == td and got.shape == (3, N, d)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_streaming_pallas_kernel_interpret(dtype):
    """K5b's regime: N = 4096 in tiles of 1024, two phases."""
    jd, td = _types(dtype)
    q, k, v = _inputs((2, 4096, 32), seed=4)
    want = jax.jit(lambda a, b, c: _pallas_linear_attention_streaming(a, b, c, tile=1024, interpret=True))(
        *(jnp.asarray(t).astype(jd) for t in (q, k, v)))
    got = LA.linear_attention(*(torch.from_numpy(t).to(td) for t in (q, k, v)))
    _check(got, want, dtype)


def test_grads_match_the_jax_op():
    """(2, 32, 16), the JAX test's shape: the gradients of sum(out^2)
    through the port's op against those through the JAX op (its custom_vjp:
    jax.vjp of the jnp composition), float32, 1e-5 of max|grad|."""
    q, k, v = _inputs((2, 32, 16), seed=5)

    def loss(a, b, c):
        return jnp.sum(j_linear_attention(a, b, c, True, True) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (LA.linear_attention(*ins) ** 2).sum().backward()
    for t, w in zip(ins, want):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_outlier_row_and_column_stay_finite():
    """A q row whose logits sit ~120 above the rest of the row, and a k
    column ~100 above the other columns: both softmaxes shift by their own
    max, so the output stays finite and within 1e-5 of max|ref| of the JAX
    composition in float32."""
    q, k, v = _inputs((2, 256, 32), seed=6)
    q[:, 7, 3] += 120.0
    k[:, :, 5] += 100.0
    want = np.asarray(_jnp_linear_attention(q, k, v))
    got = LA.linear_attention(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_context_layout():
    """ctx[bh, d, e] = sum_n softmax_N(k)[n, d] v[n, e] / N against a float64
    numpy evaluation (1e-5 of max|ctx|)."""
    _, k, v = _inputs((2, 40, 16), seed=7)
    k64, v64 = k.astype(np.float64), v.astype(np.float64)
    ks = np.exp(k64 - k64.max(1, keepdims=True))
    ks /= ks.sum(1, keepdims=True)
    want = np.einsum("bnd,bne->bde", ks, v64) / 40
    got = LA.linear_attention_context_plain(torch.from_numpy(k), torch.from_numpy(v))
    assert got.shape == (2, 16, 16) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = [kk.launches for kk in KERNELS]
    q, k, v = (torch.randn(2, 50, 32) for _ in range(3))
    assert torch.equal(LA.linear_attention(q, k, v), LA.linear_attention_plain(q, k, v))
    assert [kk.launches for kk in KERNELS] == before
    with pytest.raises(ValueError, match="CUDA"):
        LA.linear_attention_context_cuda(k, v)
    with pytest.raises(ValueError, match="CUDA"):
        LA.linear_attention_apply_heads_cuda(q, torch.zeros(2, 32, 32))
