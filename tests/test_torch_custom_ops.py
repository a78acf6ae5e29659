"""PyTorch port, the ``irsde::`` operators (K1-K5 registered through
``torch.library``) on the CPU: ``torch.library.opcheck`` of each (schema,
autograd registration, fake implementation, dynamic-shape autograd trace);
each operator's output and gradient against its plain composition's, and
against the JAX op (Pallas in interpret mode, its custom_vjp's backward)
within the bounds of the ops' parity tests (test_torch_ops.py,
test_torch_nafnet.py, test_torch_training.py, test_torch_flash_backward.py,
test_torch_linear_attention.py); no other device takes them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.ops import naf_stack as jns
from image_restoration_sde_tpu.ops.flash_attention import flash_mha as j_flash_mha
from image_restoration_sde_tpu.ops.layernorm import channel_layernorm as j_channel_layernorm
from image_restoration_sde_tpu.ops.linear_attention import linear_attention as j_linear_attention
from image_restoration_sde_tpu.ops.linear_attention import linear_attention_packed as j_linear_attention_packed
from image_restoration_sde_tpu_torch.ops import KERNELS
from image_restoration_sde_tpu_torch.ops import flash_attention as FA
from image_restoration_sde_tpu_torch.ops import layernorm as LN
from image_restoration_sde_tpu_torch.ops import linear_attention as LA
from image_restoration_sde_tpu_torch.ops import naf_stack as NS

NAF_K, NAF_C = 2, 8
NAF_SHAPES = {"conv1.weight": (2 * NAF_C, NAF_C, 1, 1), "conv1.bias": (2 * NAF_C,),
              "conv2.weight": (2 * NAF_C, 1, 3, 3), "conv2.bias": (2 * NAF_C,), "sca.1.weight": (NAF_C, NAF_C, 1, 1),
              "conv3.weight": (NAF_C, NAF_C, 1, 1), "conv4.weight": (2 * NAF_C, NAF_C, 1, 1),
              "conv4.bias": (2 * NAF_C,), "conv5.weight": (NAF_C, NAF_C, 1, 1)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _naf_tensors(r):
    """NAF_K blocks' tensors in PARAM_ORDER: kernels ~ 1/sqrt(fan_in), the
    rest ~ 0.2, the norm gains and SCA bias around 1."""
    out = []
    for _ in range(NAF_K):
        for k in NS.PARAM_ORDER:
            shape = NAF_SHAPES.get(k, (NAF_C,))
            scale = np.prod(shape[1:]) ** -0.5 if len(shape) == 4 else 0.2
            shift = 1.0 if k in ("norm1.g", "norm2.g", "sca.1.bias") else 0.0
            out.append((scale * r.standard_normal(shape) + shift).astype(np.float32))
    return out


def _case(name, seed=0):
    """(op, plain composition of the op's arguments, numpy inputs, extra
    arguments) of each operator at a small float32 site."""
    r = np.random.default_rng(seed)

    def arr(*shape, scale=1.0, shift=0.0):
        return (scale * r.standard_normal(shape) + shift).astype(np.float32)

    if name == "channel_layernorm":
        return LN.OP, LN.channel_layernorm_plain, [arr(2, 5, 7, 16, scale=1.5, shift=0.3),
                                                   arr(16, scale=0.2, shift=1.0)], (1e-5,)
    if name == "linear_attention_packed":
        return LA.PACKED_OP, LA.linear_attention_packed_plain, [arr(2, 37, 384, scale=1.5)], (4, 32)
    if name == "naf_stack":
        def plain(x, tmod, *tensors):
            return NS.naf_stack_flat_plain(x, tmod, 1e-5, tensors)

        return NS.OP, plain, [arr(2, 4, 5, NAF_C, scale=0.5), arr(NAF_K, 2, 4 * NAF_C, scale=0.3),
                              *_naf_tensors(r)], (1e-5,)
    if name == "flash_mha":
        return FA.OP, FA.flash_mha_plain, [arr(1, 256, 2, 64, scale=1.5) for _ in range(3)], (0.125,)
    return LA.HEADS_OP, LA.linear_attention_plain, [arr(3, 40, 32, scale=1.5) for _ in range(3)], ()


OPS = ["channel_layernorm", "linear_attention_packed", "naf_stack", "flash_mha", "linear_attention"]


def _op_args(name, tensors, extra):
    """The operator's argument list: K3 takes (x, tmod, eps, [tensors])."""
    if name == "naf_stack":
        return (tensors[0], tensors[1], *extra, list(tensors[2:]))
    return (*tensors, *extra)


@pytest.mark.parametrize("name", OPS)
def test_opcheck_on_the_cpu(name):
    """``torch.library.opcheck``: schema, autograd registration, the fake
    implementation against the CPU output (shape, dtype, strides), and the
    dynamic-shape autograd trace against eager (K3 on its first block: the
    trace of the plain backward takes seconds a block)."""
    op, _, arrays, extra = _case(name)
    if name == "naf_stack":
        arrays = [arrays[0], arrays[1][:1], *arrays[2 : 2 + len(NS.PARAM_ORDER)]]
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    result = torch.library.opcheck(op, _op_args(name, tensors, extra))
    assert set(result.values()) == {"SUCCESS"}


@pytest.mark.parametrize("name", OPS)
def test_op_is_its_plain_composition_forward_and_backward(name):
    """On the CPU the operator runs the plain composition: the output bit
    for bit, contiguous, and no kernel launch; the gradient of every
    floating input bit for bit (K4's: the streamed backward against
    autograd through the plain forward, 1e-5 of each max|grad|, float32
    sums in another order)."""
    op, plain, arrays, extra = _case(name)
    counts = [k.launches for k in KERNELS]
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(
        plain(*(torch.from_numpy(a) for a in arrays), *([] if name == "naf_stack" else extra)).shape
    ).astype(np.float32))

    def run(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out = fn(leaves)
        return out, torch.autograd.grad(out, leaves, cot)

    got, got_grads = run(lambda ts: op(*_op_args(name, ts, extra)))
    want, want_grads = run(lambda ts: plain(*ts, *([] if name == "naf_stack" else extra)))
    assert [k.launches for k in KERNELS] == counts
    assert got.is_contiguous() and torch.equal(got, want)
    for a, b in zip(got_grads, want_grads):
        if name == "flash_mha":
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()
        else:
            assert torch.equal(a, b)


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _jax_op(name, arrays, extra):
    """(the JAX op with Pallas in interpret mode, its array arguments): K3's
    takes x and tmod, the block tensors in its stacked layout as constants
    (``stack_params``)."""
    if name == "naf_stack":
        blocks = NS._unflatten([torch.from_numpy(a) for a in arrays[2:]])
        stacked = {k: jnp.asarray(v.numpy()) for k, v in NS.stack_params(blocks, torch.zeros(1)).items()
                   if k != "tmod"}
        return (lambda x, tmod: jns.naf_stack(x, {**stacked, "tmod": tmod}, extra[0], True, True)), arrays[:2]
    ops = {
        "channel_layernorm": lambda x, g: j_channel_layernorm(x, g, extra[0], True, True),
        "linear_attention_packed": lambda qkv: j_linear_attention_packed(qkv, *extra, True, True),
        "flash_mha": lambda q, k, v: j_flash_mha(q, k, v, extra[0], True),
        "linear_attention": lambda q, k, v: j_linear_attention(q, k, v, True, True),
    }
    return ops[name], arrays


# float32 bounds of the existing parity tests: forward, gradient (of max)
JAX_BOUNDS = {"channel_layernorm": (1e-5, 1e-5), "linear_attention_packed": (1e-5, 1e-5),
              "naf_stack": (2e-5, 1e-4), "flash_mha": (1e-5, 1e-5), "linear_attention": (1e-5, 1e-5)}


@pytest.mark.parametrize("name", OPS)
def test_op_matches_the_jax_op(name):
    """float32: the operator's output and the gradients of sum(out * cot)
    against the JAX op's (Pallas in interpret mode; jax.grad through its
    custom_vjp), within the parity tests' bounds: the output of K1 absolute
    on O(1) values and K3 absolute (test_torch_nafnet), the rest of
    max|ref|; K3's gradient of x and tmod (the JAX op takes the stacked
    layout) 1e-4 of max|grad| (test_torch_training)."""
    op, plain, arrays, extra = _case(name, seed=2)
    out_bound, grad_bound = JAX_BOUNDS[name]
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = op(*_op_args(name, leaves, extra))
    cot = np.random.default_rng(3).standard_normal(got.shape).astype(np.float32)
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    jop, jarrays = _jax_op(name, arrays, extra)
    jargs = [jnp.asarray(a) for a in jarrays]
    want = jax.jit(jop)(*jargs)
    want_grads = jax.jit(jax.grad(lambda *a: jnp.sum(jop(*a) * cot), argnums=tuple(range(len(jargs)))))(*jargs)
    err = np.abs(got.detach().numpy() - np.asarray(want)).max()
    absolute = name in ("channel_layernorm", "naf_stack")
    assert err <= (out_bound if absolute else out_bound * np.abs(np.asarray(want)).max())
    for a, b in zip(got_grads, want_grads):
        assert _rel(a.numpy(), b) <= grad_bound


def test_other_devices_have_no_implementation():
    """The operators are defined for CPU and CUDA tensors only: a meta
    tensor outside tracing takes the fake implementation, and a device
    with no implementation raises."""
    x = torch.empty(2, 4, 16, device="meta")
    assert LN.OP(x, torch.empty(16, device="meta"), 1e-5).shape == x.shape
    assert set(torch._C._dispatch_dump("irsde::channel_layernorm").split()) >= {"CPU:", "CUDA:"}
    assert "MPS:" not in torch._C._dispatch_dump("irsde::channel_layernorm")
