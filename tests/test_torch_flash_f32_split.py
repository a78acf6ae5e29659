"""PyTorch port, K4's float32 forward: the accuracy of its three-way TF32
split ("3xTF32"), emulated in float64 on the CPU.

``csrc/flash_attention.cu`` runs float32 attention on the tensor cores:
each operand x splits into x_hi = tf32(x) and x_lo = tf32(x - x_hi), both
rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``), and
each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, for q k^T and for p v
(p split the same way), over key tiles of ``F32_KEY_TILE`` with a running
max and sum.  The emulation below does that arithmetic with float64 sums
and holds it against ``flash_mha_plain`` in float64 within the card's
float32 bound, 1e-5 of max|ref|, on inputs x1.5 as ``chip_smoke.py``
makes them; one TF32 product (hi hi alone) breaks that bound on the same
inputs, so the test tells the two designs apart.  The kernel itself is
held on the card (``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from image_restoration_sde_tpu_torch.ops import flash_attention as FA

BOUND = 1e-5  # of max|ref|: chip_smoke.py's float32 bound for K4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: the low 13 bits of the magnitude rounded off."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    """float32 x -> (hi, lo) TF32 halves as float64, x = hi + lo + O(2^-22 x)."""
    hi = tf32(x)
    return hi.double(), tf32(x - hi).double()


def product(a: tuple, b: tuple, three: bool) -> torch.Tensor:
    """a @ b from the halves, float64 sums of exact TF32 products:
    a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms first), or a_hi b_hi."""
    if not three:
        return a[0] @ b[0]
    return a[1] @ b[0] + a[0] @ b[1] + a[0] @ b[0]


def emulate(q, k, v, scale, three=True, tile=FA.F32_KEY_TILE):
    """The float32 kernel's arithmetic on float32 (B, N, H, D) inputs: s =
    q k^T over the split; the running max of the raw scores; p = exp(s
    scale - m scale), a float32 value into the row sum and, split, into p
    v; the accumulator rescaled when a tile raises the max; out = acc / l."""
    qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, D)
    qs = split(qf)
    m = torch.full(qf.shape[:-1] + (1,), -1e30, dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, dtype=torch.float64)
    for j in range(0, k.shape[1], tile):
        ks = split(kf[:, :, j : j + tile].transpose(-1, -2))
        s = product(qs, ks, three)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp((m - m_new) * scale)
        p = torch.exp((s - m_new) * scale).float()
        l = l * corr + p.double().sum(dim=-1, keepdim=True)
        acc = acc * corr + product(split(p), split(vf[:, :, j : j + tile]), three)
        m = m_new
    return (acc / l).transpose(1, 2)


def reference(q, k, v, scale):
    """flash_mha_plain in float64, one head at a time."""
    return torch.cat([FA.flash_mha_plain(q[:, :, h : h + 1].double(), k[:, :, h : h + 1].double(),
                                         v[:, :, h : h + 1].double(), scale) for h in range(q.shape[2])], dim=2)


@pytest.mark.parametrize("shape", [(1, 4096, 2, 64), (1, 1000, 2, 72), (1, 35, 1, 64)], ids=str)
def test_split_meets_the_float32_bound(shape):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy((rng.standard_normal(shape) * 1.5).astype(np.float32)) for _ in range(3))
    scale = shape[-1] ** -0.5
    ref = reference(q, k, v, scale)
    limit = BOUND * ref.abs().max().item()
    three = (emulate(q, k, v, scale) - ref).abs().max().item()
    one = (emulate(q, k, v, scale, three=False) - ref).abs().max().item()
    assert three <= limit / 10, (three, limit)  # 3xTF32: float32 accuracy, with headroom for the card's sums
    assert one > limit, (one, limit)  # one TF32 product: not float32 accuracy


def test_tf32_rounds_to_nearest_away():
    x = torch.tensor([1 + 2**-11, 1 + 2**-11 + 2**-23, -(1 + 2**-11), 1 + 3 * 2**-11, 1.5, -2.0], dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1 + 2**-10, -(1 + 2**-10), 1 + 4 * 2**-10 / 2, 1.5, -2.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    hi, lo = split(x)
    assert bool(((hi + lo - x.double()).abs() <= 2.0**-22 * x.double().abs()).all())  # two halves: 22 bits
