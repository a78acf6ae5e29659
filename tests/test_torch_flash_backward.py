"""PyTorch port, K4's backward on the CPU: ``ref_mha_plain`` against the JAX
package's ``_ref_mha``; the streamed ``flash_mha_backward`` against
``jax.vjp`` of the JAX ``flash_mha`` (its Pallas forward in interpret mode;
its backward the gradient of ``_ref_mha``, streamed over 512-row q blocks
by ``_blocked_mha`` from N = 2048, un-tiled below) and against autograd
through the un-tiled ``ref_mha_plain``; the wiring of the operator
``irsde::flash_mha``, whose forward is the kernel on the card and the plain
version on the CPU, and whose backward is the streamed one on both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.ops.flash_attention import _ref_mha
from image_restoration_sde_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from image_restoration_sde_tpu_torch.ops import flash_attention as FA


def _inputs(shape, dtype, seed):
    """q, k, v ~ N(0, 1.5^2) and the output cotangent ~ N(0, 1) from numpy,
    rounded to ``dtype``; the same values as JAX arrays."""
    r = np.random.default_rng(seed)
    arrs = [(1.5 * r.standard_normal(shape)).astype(np.float32) for _ in range(3)]
    arrs.append(r.standard_normal(shape).astype(np.float32))
    port = [torch.from_numpy(a).to(dtype) for a in arrs]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return port, [jnp.asarray(t.float().numpy()).astype(jdt) for t in port]


def _rel(got: torch.Tensor, want) -> float:
    """max|got - want| / max|want|, in float64."""
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)], ids=str)
def test_ref_mha_plain_matches_jax_ref_mha(dtype, bound):
    """The JAX einsum reference's math: float32 1e-5 of max|ref| (sums in
    another order); bfloat16 2e-2 (the same roundings of p and the output,
    a float32 difference may flip one)."""
    (q, k, v, _), (jq, jk, jv, _) = _inputs((2, 200, 4, 64), dtype, seed=1)
    got = FA.ref_mha_plain(q, k, v, 0.125)
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got, _ref_mha(jq, jk, jv, 0.125)) <= bound


# (B, N, H): N = 2048 takes the JAX package's blocked backward
# (_BLOCKED_BWD_MIN_N), N = 256 its un-tiled one; the port streams at both
# (block 512: 4 blocks of 2048 and one of 256; block 64: 32 and 4)
@pytest.mark.parametrize("B,N,H", [(1, 2048, 1), (2, 256, 4)], ids=str)
@pytest.mark.parametrize("block", [512, 64])
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)], ids=str)
def test_streamed_backward_matches_jax_vjp(B, N, H, block, dtype, bound):
    """dq, dk and dv of ``flash_mha_backward`` against ``jax.vjp`` of the
    JAX ``flash_mha`` (forward in interpret mode), head dim 64.  Bounds,
    each gradient, of its max|grad|, set before the first run: float32
    1e-5 (float32 sums of up to N terms in another order); bfloat16 2e-2,
    five bf16 ulps of the largest element: both sides round p and the
    gradient of p to bfloat16, where a float32 difference may flip a
    rounding, and round dq, dk, dv once, but JAX's blocked branch also
    rounds its dk and dv partial sums to bfloat16 at every q block, where
    the port sums them in float32."""
    D = 64
    (q, k, v, g), (jq, jk, jv, jg) = _inputs((B, N, H, D), dtype, seed=N + block)
    scale = D**-0.5
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_mha(a, b, c, scale, True), jq, jk, jv)
    want = vjp(jg)
    got = FA.flash_mha_backward(q, k, v, g, scale, block=block)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == (B, N, H, D), name
        assert _rel(a, b) <= bound, name


@pytest.mark.parametrize("N,block", [(200, 64), (200, 512), (96, 32)], ids=str)
def test_streamed_backward_is_the_untiled_gradient(N, block):
    """float32: the streamed gradient (a ragged last block at N = 200,
    block 64) equals autograd through the un-tiled ``ref_mha_plain``
    within 1e-5 of each gradient's max (float32 sums in another order)."""
    (q, k, v, g), _ = _inputs((2, N, 3, 64), torch.float32, seed=N)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(FA.ref_mha_plain(*leaves, 0.125), leaves, g)
    got = FA.flash_mha_backward(q, k, v, g, 0.125, block=block)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_function_saves_the_views_and_backs_through_the_streamed_backward(monkeypatch):
    """The operator on the CPU, whose forward is the plain version (the
    kernel runs only on the card): q, k, v the strided views of one packed
    (B, N, 3, H, D) product; the gradient that reaches the packed tensor is
    ``flash_mha_backward``'s dq, dk, dv stacked on its axis 2, bit for bit,
    and the operator's autograd saved the views themselves, not copies."""
    saved = []
    orig = torch.autograd.function.FunctionCtx.save_for_backward

    def spy(ctx, *tensors):
        saved.extend(tensors)
        return orig(ctx, *tensors)

    monkeypatch.setattr(torch.autograd.function.FunctionCtx, "save_for_backward", spy)
    r = np.random.default_rng(3)
    qkv = torch.from_numpy((1.5 * r.standard_normal((2, 300, 3, 2, 64))).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(r.standard_normal((2, 300, 2, 64)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    out = FA.flash_mha(q, k, v, 0.125)
    assert out.grad_fn is not None and torch.equal(out, FA.flash_mha_plain(q, k, v, 0.125))
    assert [t.data_ptr() for t in saved] == [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    assert all(t.stride() == q.stride() for t in saved)
    (got,) = torch.autograd.grad(out, qkv, g)
    want = torch.stack(FA.flash_mha_backward(q.detach(), k.detach(), v.detach(), g, 0.125), dim=2)
    assert torch.equal(got, want)
