"""PyTorch port, the Refusion latent path: the compressor UNet's key map
against ``latent_unet_key_rules`` and its encode / decode / forward against
flax; encode -> latent reverse chain through the tiny ConditionalNAFNet ->
decode against the JAX package with the same weights and noise; the port's
``make_latent_sampler`` API; import hygiene of the port package."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.models.latent_unet import UNet as FlaxCompressor
from image_restoration_sde_tpu.models.nafnet import ConditionalNAFNet as FlaxNAFNet
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu.utils.torch_import import latent_unet_key_rules
from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, UNet, modules
from image_restoration_sde_tpu_torch.sde import IRSDE, rng, samplers
from image_restoration_sde_tpu_torch.training import make_latent_sampler
from image_restoration_sde_tpu_torch.utils import latent_unet_flax_keys, nafnet_flax_keys, state_dict_from_flax
from test_torch_nafnet import randomize
from test_torch_unet import KIND_OF, flatten, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMP = dict(in_ch=3, out_ch=3, ch=4, ch_mult=(1, 2), embed_dim=4)
NAF = dict(img_channel=4, width=8, enc_blk_nums=(1, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
SDE_ARGS = dict(max_sigma=50.0, T=100, schedule="cosine", eps=0.005)
STEPS = 10


def _nchw(a) -> torch.Tensor:
    """NHWC array -> NCHW tensor in channels_last memory."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def weights():
    fc = FlaxCompressor(**COMP)
    x = jnp.zeros((1, 16, 16, 3))
    comp = randomize(flatten(jax.jit(fc.init)(jax.random.PRNGKey(0), x)), seed=3)
    fn = FlaxNAFNet(**NAF)
    z = jnp.zeros((1, 16, 16, NAF["img_channel"]))
    naf = randomize(flatten(jax.jit(fn.init)(jax.random.PRNGKey(1), z, z, jnp.array([1.0]))), seed=4)
    return comp, naf


def port_compressor(w) -> UNet:
    net = UNet(**COMP)
    net.load_state_dict(state_dict_from_flax(w, keys=latent_unet_flax_keys(len(COMP["ch_mult"]))))
    return net.eval()


def port_nafnet(w) -> ConditionalNAFNet:
    net = ConditionalNAFNet(**NAF)
    keys = nafnet_flax_keys(NAF["enc_blk_nums"], NAF["middle_blk_num"], NAF["dec_blk_nums"])
    net.load_state_dict(state_dict_from_flax(w, keys=keys))
    return net.eval()


# ------------------------------------------------------------ compressor
@pytest.mark.parametrize("depth", [2, 4])
def test_key_map_matches_latent_unet_key_rules(depth):
    rules = latent_unet_key_rules(depth)
    keys = latent_unet_flax_keys(depth)
    assert {fp for fp, _ in keys.values()} == set(rules) and len(keys) == len(rules)
    for tkey, (fpath, kind) in keys.items():
        r_tkey, r_tf = rules[fpath]
        assert r_tkey == tkey, fpath
        assert KIND_OF[r_tf.__name__] == kind, fpath
    mult = (1, 2, 2, 4)[:depth]
    assert set(keys) == set(UNet(ch=4, ch_mult=mult, embed_dim=4).state_dict())


@pytest.mark.parametrize("hw", [(16, 16), (18, 13)], ids=str)
def test_compressor_matches_flax_f32(weights, hw):
    """encode (the latent and every skip), decode (from the same latent and
    skips) and forward; 18x13 reflect-pads to 20x16.  Bound 1e-5 of
    max|ref|: float32 convolutions in another order through ~15 layers."""
    w = weights[0]
    fc, params = FlaxCompressor(**COMP), unflatten(w)
    img = np.random.default_rng(5).random((2, *hw, 3), np.float32)
    lat, hs = jax.jit(lambda p, a: fc.apply(p, a, method=fc.encode))(params, img)
    dec = jax.jit(lambda p, l, h: fc.apply(p, l, h, method=fc.decode))(params, lat, hs)
    fwd = jax.jit(fc.apply)(params, img)
    net = port_compressor(w)
    with torch.inference_mode():
        plat, phs = net.encode(torch.from_numpy(img))
        pdec = net.decode(torch.from_numpy(np.array(lat)), [_nchw(h) for h in hs])
        pfwd = net(torch.from_numpy(img))

    def close(got, want):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    close(plat.numpy(), lat)
    assert len(phs) == len(hs) == 1 + 2 * len(COMP["ch_mult"])
    for a, b in zip(phs, hs):
        close(a.permute(0, 2, 3, 1).numpy(), b)
    close(pdec.numpy(), dec)
    assert pfwd.shape == img.shape
    close(pfwd.numpy(), fwd)


def test_compressor_kernel_sites_get_contiguous_rows(weights, monkeypatch):
    """Every K1 and K2 call of encode and decode gets contiguous rows (the
    CUDA wrappers raise rather than copy): 2 LayerNorms and one attention
    per attention block, which sit at the deepest level only."""
    seen = []

    def check(fn):
        def wrapped(x, *a):
            seen.append(x.is_contiguous())
            return fn(x, *a)

        return wrapped

    monkeypatch.setattr(modules, "channel_layernorm", check(modules.channel_layernorm))
    monkeypatch.setattr(modules, "linear_attention_packed", check(modules.linear_attention_packed))
    with torch.inference_mode():
        port_compressor(weights[0])(torch.rand(1, 18, 13, 3))
    assert len(seen) == 2 * 3 and all(seen)


# ------------------------------------------------------ the slice as a whole
@pytest.mark.parametrize("mode", ["posterior", "sde"])
def test_latent_chain_matches_jax(weights, mode, monkeypatch):
    """encode -> noisy = latent + max_sigma * z0 -> 10 reverse steps (t = 10..1)
    through the tiny NAFNet (its 4-block level fused on both sides) ->
    decode with the LQ skips -> crop, composed as make_latent_sampler does,
    with the same weights, z0 and noise_seq on both sides.  float32; bound
    1e-4 of max|ref|: the nets' float32 rounding differences pass through
    10 steps whose coefficients stay O(1)."""
    monkeypatch.setenv("IRSDE_NAF_FUSE_INTERPRET", "1")
    comp_w, naf_w = weights
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    r = np.random.default_rng(6)
    lq = r.random((2, 30, 26, 3), np.float32)
    lat_shape = (2, 16, 14, COMP["embed_dim"])  # 30x26 reflect-pads to 32x28, then /2
    z0 = r.standard_normal(lat_shape).astype(np.float32)
    noise_seq = r.standard_normal((STEPS, *lat_shape)).astype(np.float32)

    fc, fn = FlaxCompressor(**COMP), FlaxNAFNet(**NAF)
    cp, npar = unflatten(comp_w), unflatten(naf_w)
    jrev = {"posterior": jsamplers.reverse_posterior, "sde": jsamplers.reverse_sde}[mode]

    def jax_chain(img, z, ns):
        latent, hidden = fc.apply(cp, img, method=fc.encode)
        noisy = latent + ref.max_sigma * z
        out = jrev(ref, lambda x, m, t: fn.apply(npar, x, m, t), noisy, latent, steps=STEPS, noise_seq=ns)
        return fc.apply(cp, out, hidden, method=fc.decode)[:, : img.shape[1], : img.shape[2], :]

    want = np.asarray(jax.jit(jax_chain)(lq, z0, noise_seq))

    comp, naf = port_compressor(comp_w), port_nafnet(naf_w)
    prev = {"posterior": samplers.reverse_posterior, "sde": samplers.reverse_sde}[mode]
    with torch.inference_mode():
        latent, hidden = comp.encode(torch.from_numpy(lq))
        assert latent.shape == lat_shape
        noisy = latent + port.max_sigma * torch.from_numpy(z0)
        out = prev(port, naf, noisy, latent, steps=STEPS, noise_seq=torch.from_numpy(noise_seq))
        got = comp.decode(out, hidden)[:, :30, :26, :].numpy()
    assert got.shape == lq.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------------ make_latent_sampler API
@pytest.fixture(scope="module")
def port_pair(weights):
    return port_nafnet(weights[1]), port_compressor(weights[0])


def test_sampler_is_the_composition_with_its_generator_draws(port_pair):
    """sample(lq, gen) == decode(reverse(encode(lq) + max_sigma * z0,
    noise_seq)), with z0 and then noise_seq drawn from a generator of the
    same seed in the sampler's order: nothing else draws or differs."""
    naf, comp = port_pair
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    lq = torch.rand(2, 18, 13, 3, generator=rng.generator(1, "cpu"))
    got = make_latent_sampler(sde, naf, comp, mode="posterior", steps=3)(lq, rng.generator(9, "cpu"))
    g = rng.generator(9, "cpu")
    with torch.inference_mode():
        latent, hidden = comp.encode(lq)
        z0 = torch.randn(latent.shape, generator=g)
        ns = torch.stack([torch.randn(latent.shape, generator=g) for _ in range(3)])
        out = samplers.reverse_posterior(sde, naf, latent + z0 * sde.max_sigma, latent, steps=3, noise_seq=ns)
        want = comp.decode(out, hidden)[:, :18, :13, :]
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["posterior", "sde", "ode"])
def test_sampler_output_shape_crop_and_determinism(port_pair, mode):
    naf, comp = port_pair
    sample = make_latent_sampler(IRSDE.create(**SDE_ARGS, device="cpu"), naf, comp, mode=mode, steps=2)
    lq = torch.rand(2, 18, 13, 3, generator=rng.generator(2, "cpu"))
    a = sample(lq, rng.generator(7, "cpu"))
    assert a.shape == lq.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
    assert torch.equal(a, sample(lq, rng.generator(7, "cpu")))
    assert not torch.equal(a, sample(lq, rng.generator(8, "cpu")))  # ode: z0 still differs


def test_per_sample_generators_make_chunking_invisible(port_pair):
    """Batch 4 in chunks of 2 agrees with the whole batch (1e-6: batched
    convolutions may sum in another order); changing chunk 1's input
    leaves chunk 0 bitwise unchanged."""
    naf, comp = port_pair
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    lq = torch.rand(4, 16, 16, 3, generator=rng.generator(3, "cpu"))
    whole = make_latent_sampler(sde, naf, comp, mode="sde", steps=2)
    chunked = make_latent_sampler(sde, naf, comp, mode="sde", steps=2, chunk=2)
    a = whole(lq, rng.generators_for_seeds([1, 2, 3, 4], "cpu"))
    b = chunked(lq, rng.generators_for_seeds([1, 2, 3, 4], "cpu"))
    assert torch.allclose(a, b, rtol=0, atol=1e-6)
    lq2 = lq.clone()
    lq2[2:] = torch.rand(2, 16, 16, 3, generator=rng.generator(4, "cpu"))
    c = chunked(lq2, rng.generators_for_seeds([1, 2, 3, 4], "cpu"))
    assert torch.equal(c[:2], b[:2]) and not torch.equal(c[2:], b[2:])


def test_cast_params_applies_to_the_score_net_only(port_pair):
    naf, comp = port_pair
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    lq = torch.rand(1, 16, 16, 3, generator=rng.generator(5, "cpu"))
    cast = make_latent_sampler(sde, naf, comp, mode="ode", steps=2, cast_params=torch.bfloat16)(
        lq, rng.generator(1, "cpu"))
    ref = make_latent_sampler(sde, naf, comp, mode="ode", steps=2)(lq, rng.generator(1, "cpu"))
    assert torch.isfinite(cast).all() and not torch.equal(cast, ref)
    assert all(p.dtype == torch.float32 for p in [*naf.parameters(), *comp.parameters()])
    with pytest.raises(ValueError, match="sampling mode"):
        make_latent_sampler(sde, naf, comp, mode="euler")


# ---------------------------------------------------------------- hygiene
def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port and the scripts that run it on the card
    (chip_smoke.py, chip_profile.py, chip_compare.py, chip_learn.py): no
    import of jax, jaxlib, flax or image_restoration_sde_tpu (the port's
    own package name aside)."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|image_restoration_sde_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, name) for name in ("chip_smoke.py", "chip_profile.py", "chip_compare.py",
                                                   "chip_learn.py")]
    for root, _, names in os.walk(os.path.join(REPO, "image_restoration_sde_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            assert not bad.search(f.read()), path
