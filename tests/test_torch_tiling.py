"""PyTorch port, tiled restoration: the grid and feather against the JAX
package's; exact reconstruction and seamlessness; the host and device
versions against each other (float32 and uint8); per-tile noise keyed by
the tile's place in the grid, so the result does not depend on
``tile_batch``, through a tiny DiT latent sampler."""

import numpy as np
import pytest
import torch

from image_restoration_sde_tpu import tiling as jtiling
from image_restoration_sde_tpu_torch import tiling
from image_restoration_sde_tpu_torch.models import DiT, UNet, init_params_
from image_restoration_sde_tpu_torch.sde import IRSDE, rng
from image_restoration_sde_tpu_torch.sde.rng import normal_like
from image_restoration_sde_tpu_torch.training import make_latent_sampler

ENTRIES = (tiling.tiled_restore, tiling.tiled_restore_device)


def _image(shape, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    if dtype == np.uint8:
        return r.integers(0, 256, shape).astype(np.uint8)
    return r.random(shape).astype(np.float32)


@pytest.mark.parametrize("L,t,o", [(100, 40, 8), (512, 128, 32), (40, 64, 16), (130, 64, 0), (1536, 1024, 64)])
def test_grid_and_feather_equal_the_jax_ones(L, t, o):
    t = min(t, L)
    starts = tiling.tile_grid(L, t, o)
    assert starts == jtiling.tile_grid(L, t, o)
    covered = np.zeros(L, bool)
    for s in starts:
        covered[s : s + t] = True
    assert covered.all()
    np.testing.assert_array_equal(tiling._feather_profile(t, min(o, t // 2)),
                                  jtiling._feather_profile(t, min(o, t // 2)))


@pytest.mark.parametrize("entry", ENTRIES, ids=lambda f: f.__name__)
def test_identity_sampler_reconstructs_exactly(entry):
    img = _image((1, 100, 140, 3), 0)
    out = entry(lambda tiles, gens: tiles, img, None, tile=48, overlap=16, tile_batch=3, device="cpu")
    assert out.dtype == np.float32 and out.shape == img.shape
    np.testing.assert_allclose(out, img, rtol=0, atol=1e-6)


@pytest.mark.parametrize("entry", ENTRIES, ids=lambda f: f.__name__)
def test_pointwise_function_is_seamless(entry):
    img = _image((1, 96, 96, 3), 1)
    out = entry(lambda tiles, gens: torch.sqrt(tiles) * 0.7, img, None, tile=40, overlap=12, device="cpu")
    np.testing.assert_allclose(out, np.sqrt(img) * 0.7, rtol=0, atol=1e-5)


def _mix(seed):
    m = torch.from_numpy(np.random.default_rng(seed).random((3, 3)).astype(np.float32))
    return lambda tiles, gens: torch.einsum("bhwc,cd->bhwd", tiles, m) * 0.5 + 0.1


def test_device_and_host_versions_agree_f32():
    """Same grid, same feather; the host blends in float64, the device in
    float32: 2e-5 apart, as in the JAX package's test."""
    img = _image((1, 100, 140, 3), 2)
    kw = dict(tile=48, overlap=16, tile_batch=3, device="cpu")
    host = tiling.tiled_restore(_mix(2), img, None, **kw)
    dev = tiling.tiled_restore_device(_mix(2), img, None, **kw)
    assert dev.dtype == host.dtype == np.float32
    np.testing.assert_allclose(dev, host, rtol=0, atol=2e-5)


def test_device_and_host_versions_agree_uint8():
    """uint8 in, uint8 out on both; the identity round-trips exactly, a
    channel mix agrees to one level (rounding of a float32 and a float64
    blend at .5)."""
    img = _image((1, 70, 90, 3), 3, np.uint8)
    kw = dict(tile=40, overlap=12, tile_batch=2, device="cpu")
    for entry in ENTRIES:
        out = entry(lambda tiles, gens: tiles, img, None, **kw)
        assert out.dtype == np.uint8 and out.shape == img.shape
        np.testing.assert_array_equal(out, img)
    host = tiling.tiled_restore(_mix(3), img, None, **kw)
    dev = tiling.tiled_restore_device(_mix(3), img, None, **kw)
    assert host.dtype == dev.dtype == np.uint8
    assert np.abs(host.astype(int) - dev.astype(int)).max() <= 1


def _noise_sampler(tiles, gens):
    return normal_like(gens, tiles)  # the output is the tile's noise


@pytest.mark.parametrize("entry", ENTRIES, ids=lambda f: f.__name__)
def test_each_tile_draws_its_own_noise_whatever_the_chunking(entry):
    """Two tiles side by side, no overlap: each shows its own generator's
    draw; the same with one tile per chunk and with both in one chunk."""
    img = np.zeros((1, 20, 40, 3), np.float32)
    one = entry(_noise_sampler, img, 7, tile=20, overlap=0, tile_batch=1, device="cpu")
    two = entry(_noise_sampler, img, 7, tile=20, overlap=0, tile_batch=2, device="cpu")
    np.testing.assert_array_equal(one, two)
    left, right = one[0, :, :20], one[0, :, 20:]
    assert np.abs(left - right).max() > 1e-3
    want = torch.randn((20, 20, 3), generator=rng.generator(tiling.tile_seed(7, 1), "cpu")).numpy()
    np.testing.assert_array_equal(right, want)
    assert not np.array_equal(one, entry(_noise_sampler, img, 8, tile=20, overlap=0, device="cpu"))


def test_result_does_not_depend_on_tile_batch_through_a_dit_latent_sampler():
    """A tiny DiT latent sampler (sde mode: noise every step) over 6 tiles
    in chunks of 1, 2 and 4 (the last chunk short): the same result up to
    float32 sums taken in batches of another size (1e-5 of max|out|).
    Keyed by chunk, as the JAX package keys them, the noise would differ
    and so would the result, by O(1)."""
    gen = torch.Generator().manual_seed(0)
    comp = init_params_(UNet(in_ch=3, out_ch=3, ch=4, ch_mult=(1, 2), embed_dim=4), gen).eval()
    net = init_params_(DiT(hidden_size=32, depth=1, num_heads=2, patch_size=2, in_channels=4), gen).eval()
    sde = IRSDE.create(max_sigma=10.0, T=100, schedule="cosine", eps=0.005, device="cpu")
    sampler = make_latent_sampler(sde, net, comp, mode="sde", steps=3)
    img = _image((1, 24, 40, 3), 4, np.uint8)
    outs = [tiling.tiled_restore_device(sampler, img, 5, tile=16, overlap=4, tile_batch=b, device="cpu")
            for b in (1, 2, 4)]
    f32 = [tiling.tiled_restore_device(sampler, img.astype(np.float32) / 255, 5, tile=16, overlap=4,
                                       tile_batch=b, device="cpu") for b in (1, 2, 4)]
    assert all(o.shape == img.shape and o.dtype == np.uint8 for o in outs)
    assert np.isfinite(f32[0]).all() and np.abs(f32[0]).max() > 0
    for o in f32[1:]:
        assert np.abs(o - f32[0]).max() <= 1e-5 * np.abs(f32[0]).max()
    for o in outs[1:]:
        assert np.abs(o.astype(int) - outs[0].astype(int)).max() <= 1
    other = tiling.tiled_restore_device(sampler, img.astype(np.float32) / 255, 6, tile=16, overlap=4, device="cpu")
    assert np.abs(other - f32[0]).max() > 1e-2


def test_refuses_a_batch():
    for entry in ENTRIES:
        with pytest.raises(ValueError, match="one NHWC image"):
            entry(lambda t, g: t, np.zeros((2, 8, 8, 3), np.float32), None, device="cpu")
