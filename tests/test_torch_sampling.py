"""PyTorch port, the slice as a whole: the tiny ConditionalUNet inside the
IR-SDE reverse chains against the JAX package with the same weights, the
same initial state and the same noise; the port's sampler API."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu import sampling as jsampling
from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu_torch import sampling
from image_restoration_sde_tpu_torch.models import ConditionalUNet
from image_restoration_sde_tpu_torch.sde import IRSDE, rng, samplers
from image_restoration_sde_tpu_torch.utils import state_dict_from_flax
from test_torch_unet import TINY, random_flax_params, unflatten

SDE_ARGS = dict(max_sigma=10.0, T=100, schedule="cosine", eps=0.005)
STEPS = 10
SHAPE = (2, 32, 32, 3)


@pytest.fixture(scope="module")
def pair():
    weights = random_flax_params(TINY["depth"], TINY["nf"], seed=1)
    net = ConditionalUNet(**TINY)
    net.load_state_dict(state_dict_from_flax(weights, TINY["depth"]))
    return net, FlaxUNet(**TINY), unflatten(weights)


@pytest.mark.parametrize("mode", ["posterior", "sde"])
def test_chain_with_net_matches_jax(pair, mode):
    """10 reverse steps (t = 10..1) through the tiny net, float32, with
    noisy = lq + max_sigma * z0 and the same noise_seq on both sides.
    Bound 1e-4 of max|ref|: the net's float32 rounding differences (1e-6
    of its output) pass through 10 steps whose coefficients stay O(1)."""
    net, fnet, params = pair
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    r = np.random.default_rng(4)
    lq = r.random(SHAPE, np.float32)
    noisy = (lq + float(port.max_sigma) * r.standard_normal(SHAPE)).astype(np.float32)
    noise_seq = r.standard_normal((STEPS, *SHAPE)).astype(np.float32)

    jfn = {"posterior": jsamplers.reverse_posterior, "sde": jsamplers.reverse_sde}[mode]
    want = jax.jit(
        lambda xt, mu, ns: jfn(ref, lambda x, m, t: fnet.apply(params, x, m, t), xt, mu, steps=STEPS, noise_seq=ns)
    )(noisy, lq, noise_seq)
    pfn = {"posterior": samplers.reverse_posterior, "sde": samplers.reverse_sde}[mode]
    with torch.inference_mode():
        got = pfn(port, net, torch.from_numpy(noisy), torch.from_numpy(lq), steps=STEPS,
                  noise_seq=torch.from_numpy(noise_seq))
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["posterior", "sde", "ode"])
def test_sampler_is_deterministic_for_a_fixed_generator(pair, mode):
    net = pair[0]
    sample = sampling.make_restoration_sampler(IRSDE.create(**SDE_ARGS, device="cpu"), net, mode=mode, steps=3)
    lq = torch.rand(2, 20, 20, 3, generator=rng.generator(0, "cpu"))
    a = sample(lq, rng.generator(7, "cpu"))
    b = sample(lq, rng.generator(7, "cpu"))
    assert a.shape == lq.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
    assert torch.equal(a, b)
    if mode != "ode":
        assert not torch.equal(a, sample(lq, rng.generator(8, "cpu")))


def test_per_sample_generators_make_chunking_invisible(pair):
    net = pair[0]
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    lq = torch.rand(4, 16, 16, 3, generator=rng.generator(1, "cpu"))
    whole = sampling.make_restoration_sampler(sde, net, mode="posterior", steps=2)
    chunked = sampling.make_restoration_sampler(sde, net, mode="posterior", steps=2, chunk=2)
    a = whole(lq, rng.generators_for_seeds([1, 2, 3, 4], "cpu"))
    b = chunked(lq, rng.generators_for_seeds([1, 2, 3, 4], "cpu"))
    # one sample alone, with its own generator, gets the same result
    c = whole(lq[2:3], rng.generators_for_seeds([3], "cpu"))
    assert torch.allclose(a, b, rtol=0, atol=1e-6) and torch.allclose(a[2:3], c, rtol=0, atol=1e-6)


def test_cast_params_runs_the_net_with_cast_weights(pair):
    net = pair[0]
    params = dict(net.named_parameters())
    cast = sampling.cast_f32_leaves({**params, "steps": torch.tensor(3)}, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for k, v in cast.items() if k != "steps")
    assert cast["steps"].dtype == torch.int64
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    lq = torch.rand(1, 16, 16, 3, generator=rng.generator(2, "cpu"))
    out = sampling.make_restoration_sampler(sde, net, mode="ode", steps=2, cast_params=torch.bfloat16)(lq, None)
    ref = sampling.make_restoration_sampler(sde, net, mode="ode", steps=2)(lq, None)
    assert torch.isfinite(out).all() and not torch.equal(out, ref)
    assert all(p.dtype == torch.float32 for p in net.parameters())


@pytest.mark.parametrize("batch,chunk,want", [(8, None, 8), (8, 0, 8), (8, 4, 4), (6, 4, 3), (11, 8, 11), (3, 8, 3)])
def test_sample_chunk(batch, chunk, want):
    assert sampling._sample_chunk(batch, chunk) == want


def test_bad_mode_raises(pair):
    with pytest.raises(ValueError, match="sampling mode"):
        sampling.make_restoration_sampler(IRSDE.create(**SDE_ARGS, device="cpu"), pair[0], mode="euler")


@pytest.mark.parametrize("hw", [(100, 140), (64, 64), (65, 1)], ids=str)
def test_pad_to_bucket_round_trip_matches_jax(hw):
    img = np.random.default_rng(5).random((1, *hw, 3), np.float32)
    padded, got_hw = sampling.pad_to_bucket(img)
    jpadded, jhw = jsampling.pad_to_bucket(img)
    assert got_hw == jhw == hw and padded.shape[1] % 64 == 0 and padded.shape[2] % 64 == 0
    np.testing.assert_array_equal(padded, jpadded)
    np.testing.assert_array_equal(sampling.unpad(padded, got_hw), img)
    np.testing.assert_array_equal(sampling.unpad(torch.from_numpy(padded), got_hw).numpy(), img)
