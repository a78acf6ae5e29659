"""PyTorch port, DiT-XL/2 (what the bare DiT class builds): the port's
``DiT_XL_2`` at its full width (hidden 1152, 16 heads of 72, patch 2), cut in
depth, against the flax ``DiT_XL_2`` on the same numpy-seeded weights and
inputs, float32 and bfloat16; the bare class's size on both sides; a 3-step
latent posterior chain through it against the JAX composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.models.dit import DiT as FlaxDiT
from image_restoration_sde_tpu.models.dit import DiT_XL_2 as FlaxDiT_XL_2
from image_restoration_sde_tpu.models.latent_unet import UNet as FlaxCompressor
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu_torch.models import DiT, UNet, build_network
from image_restoration_sde_tpu_torch.sampling import make_noise_fn
from image_restoration_sde_tpu_torch.sde import IRSDE, samplers
from image_restoration_sde_tpu_torch.utils import dit_flax_keys, latent_unet_flax_keys, state_dict_from_flax
from test_torch_dit import COMP, SDE_ARGS
from test_torch_nafnet import randomize
from test_torch_unet import unflatten

IN_CH = 8  # the latent dehazing compressor's embed_dim
CHAIN_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this module: the suite runs several workers on
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shapes(tree) -> dict:
    """A ``jax.eval_shape`` parameter tree flattened as ``flatten`` keys it:
    path -> ShapeDtypeStruct."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path[1:]): leaf for path, leaf in flat}


def _xl_weights(depth: int, in_channels: int, seed: int) -> dict:
    """The flax DiT_XL_2's parameters at ``depth`` (shapes from
    ``jax.eval_shape``), every leaf seeded (``randomize``: flax zeroes adaLN
    and the final layer)."""
    z = jnp.zeros((1, 16, 16, in_channels))
    shapes = jax.eval_shape(FlaxDiT_XL_2(depth=depth, in_channels=in_channels).init, jax.random.PRNGKey(0), z, z,
                            jnp.array([1.0]))
    return randomize(_shapes(shapes), seed=seed)


def _port_xl(w: dict, depth: int, in_channels: int, **kw) -> DiT:
    net = build_network("DiT_XL_2", {"in_channels": in_channels, "depth": depth, **kw})
    net.load_state_dict(state_dict_from_flax(w, keys=dit_flax_keys(depth)))
    return net.eval()


@pytest.fixture(scope="module")
def xl_weights():
    return _xl_weights(2, IN_CH, seed=21)


def _inputs(seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, 16, 16, IN_CH)).astype(np.float32)
    cond = r.standard_normal((2, 16, 16, IN_CH)).astype(np.float32)
    return x, cond, np.array([5.0, 88.0], np.float32)


def _flax_xl(w, dtype, inputs):
    net = FlaxDiT_XL_2(depth=2, in_channels=IN_CH, dtype=dtype)
    return np.asarray(jax.jit(net.apply)(unflatten(w), *inputs))


def test_dit_xl_matches_flax_f32(xl_weights):
    """Two blocks at full width on a 16x16x8 latent (64 tokens, heads of
    72).  Bound 1e-5 of max|ref|, as ``test_dit_matches_flax_f32``."""
    inputs = _inputs(seed=3)
    want = _flax_xl(xl_weights, jnp.float32, inputs)
    net = _port_xl(xl_weights, 2, IN_CH)
    assert net.blocks[0].attn.heads == 16 and net.blocks[0].attn.proj.in_features // 16 == 72
    with torch.inference_mode():
        got = net(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape == (2, 16, 16, IN_CH) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_dit_xl_matches_flax_bf16(xl_weights):
    """bf16 compute with float32 parameters; bound twice the flax bf16
    result's own distance from flax float32, as ``test_dit_matches_flax_bf16``."""
    inputs = _inputs(seed=4)
    want = _flax_xl(xl_weights, jnp.bfloat16, inputs)
    f32 = _flax_xl(xl_weights, jnp.float32, inputs)
    with torch.inference_mode():
        got = _port_xl(xl_weights, 2, IN_CH, dtype="bfloat16")(*map(torch.from_numpy, inputs)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2 * np.abs(want - f32).max()


def test_bare_dit_is_dit_xl_on_both_sides():
    """The bare class builds hidden 1152, 28 blocks, 16 heads (head dim 72),
    patch 2 in both packages, with the same parameters key for key."""
    flax_net = FlaxDiT(in_channels=IN_CH)
    assert (flax_net.hidden_size, flax_net.depth, flax_net.num_heads, flax_net.patch_size) == (1152, 28, 16, 2)
    z = jnp.zeros((1, 16, 16, IN_CH))
    flat = _shapes(jax.eval_shape(flax_net.init, jax.random.PRNGKey(0), z, z, jnp.array([1.0])))
    with torch.device("meta"):
        bare = DiT(in_channels=IN_CH)
        xl = build_network("DiT_XL_2", {"in_channels": IN_CH})
    for net in (bare, xl):
        attn = net.blocks[0].attn
        assert len(net.blocks) == 28 and attn.heads == 16 and attn.proj.in_features == 1152
        assert attn.qkv.weight.shape == (3 * 1152, 1152) and net.patch_size == 2
    keys = dit_flax_keys(28)
    assert set(bare.state_dict()) == set(xl.state_dict()) == set(keys)
    assert {fp for fp, _ in keys.values()} == set(flat)
    assert sum(p.numel() for p in bare.parameters()) == sum(int(np.prod(v.shape)) for v in flat.values())


def test_latent_chain_through_dit_xl_matches_jax():
    """encode -> noisy = latent + max_sigma * z0 -> 3 posterior steps through
    DiT_XL_2 at depth 1 -> decode with the LQ skips -> crop, as
    ``test_latent_chain_through_dit_matches_jax`` composes it, with the same
    weights, z0 and noise_seq on both sides.  float32; bound 1e-4 of
    max|ref|, as there."""
    in_ch = COMP["embed_dim"]
    dit_w = _xl_weights(1, in_ch, seed=22)
    fc = FlaxCompressor(**COMP)
    comp_w = randomize(_shapes(jax.eval_shape(fc.init, jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)))), seed=23)
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    r = np.random.default_rng(24)
    lq = r.random((1, 30, 26, 3), np.float32)
    lat_shape = (1, 16, 14, in_ch)  # 30x26 reflect-pads to 32x28, then /2
    z0 = r.standard_normal(lat_shape).astype(np.float32)
    noise_seq = r.standard_normal((CHAIN_STEPS, *lat_shape)).astype(np.float32)

    fd = FlaxDiT_XL_2(depth=1, in_channels=in_ch)
    cp, dp = unflatten(comp_w), unflatten(dit_w)

    def jax_chain(img, z, ns):
        latent, hidden = fc.apply(cp, img, method=fc.encode)
        noisy = latent + ref.max_sigma * z
        out = jsamplers.reverse_posterior(ref, lambda x, m, t: fd.apply(dp, x, m, t), noisy, latent,
                                          steps=CHAIN_STEPS, noise_seq=ns)
        return fc.apply(cp, out, hidden, method=fc.decode)[:, : img.shape[1], : img.shape[2], :]

    want = np.asarray(jax.jit(jax_chain)(lq, z0, noise_seq))

    comp = UNet(**COMP)
    comp.load_state_dict(state_dict_from_flax(comp_w, keys=latent_unet_flax_keys(len(COMP["ch_mult"]))))
    comp.eval()
    fn = make_noise_fn(_port_xl(dit_w, 1, in_ch), None)
    with torch.inference_mode():
        latent, hidden = comp.encode(torch.from_numpy(lq))
        assert latent.shape == lat_shape
        noisy = latent + port.max_sigma * torch.from_numpy(z0)
        out = samplers.reverse_posterior(port, fn, noisy, latent, steps=CHAIN_STEPS,
                                         noise_seq=torch.from_numpy(noise_seq))
        got = comp.decode(out, hidden)[:, :30, :26, :].numpy()
    assert got.shape == lq.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
