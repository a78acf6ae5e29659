"""PyTorch port, latent bokeh: the bokeh NAFNet (lens conditioning) against
flax with the same weights, its key map against ``bokeh_nafnet_key_rules``,
a 10-step latent chain with the lens values as ``cond`` against the JAX
package (same weights, z0 and noise_seq), and ``make_latent_sampler``'s
``cond``: forwarded every step, sliced with the batch when chunking."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.models.bokeh_nafnet import BokehConditionalNAFNet as FlaxBokeh
from image_restoration_sde_tpu.models.latent_unet import UNet as FlaxCompressor
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu.utils.torch_import import bokeh_nafnet_key_rules
from image_restoration_sde_tpu_torch.models import BokehConditionalNAFNet, build_network
from image_restoration_sde_tpu_torch.models import nafnet as pnafnet
from image_restoration_sde_tpu_torch.ops import KERNELS
from image_restoration_sde_tpu_torch.sde import IRSDE, rng, samplers
from image_restoration_sde_tpu_torch.training import make_latent_sampler
from image_restoration_sde_tpu_torch.utils import bokeh_nafnet_flax_keys, state_dict_from_flax
from test_torch_latent import COMP, port_compressor
from test_torch_nafnet import randomize
from test_torch_unet import KIND_OF, flatten, unflatten

TINY = dict(img_channel=4, width=8, enc_blk_nums=(1, 2), middle_blk_num=1, dec_blk_nums=(1, 1))
CONFIG = dict(img_channel=4, width=64, enc_blk_nums=(2, 2, 4, 8), middle_blk_num=12, dec_blk_nums=(2, 2, 2, 2))
SDE_ARGS = dict(max_sigma=50.0, T=100, schedule="cosine", eps=0.005)
STEPS = 10


def _lens(batch, seed):
    r = np.random.default_rng(seed)
    return tuple(v.astype(np.float32) for v in (r.uniform(1, 20, batch), r.uniform(1, 20, batch), r.random(batch)))


@pytest.fixture(scope="module")
def weights():
    fc = FlaxCompressor(**COMP)
    comp = randomize(flatten(jax.jit(fc.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))), seed=5)
    z = jnp.zeros((1, 16, 16, TINY["img_channel"]))
    lens = tuple(jnp.zeros((1,)) for _ in range(3))
    init = jax.jit(lambda k, x: FlaxBokeh(**TINY).init(k, x, x, jnp.array([1.0]), lens_info=lens))
    return comp, randomize(flatten(init(jax.random.PRNGKey(1), z)), seed=6)


def port_net(w, dtype=torch.float32) -> BokehConditionalNAFNet:
    net = BokehConditionalNAFNet(**TINY, dtype=dtype)
    keys = bokeh_nafnet_flax_keys(TINY["enc_blk_nums"], TINY["middle_blk_num"], TINY["dec_blk_nums"])
    net.load_state_dict(state_dict_from_flax(w, keys=keys))
    return net.eval()


# ------------------------------------------------------------- the net
@pytest.mark.parametrize("cfg", [TINY, CONFIG], ids=["tiny", "latent-bokeh"])
def test_key_map_matches_bokeh_nafnet_key_rules(cfg):
    dims = (cfg["enc_blk_nums"], cfg["middle_blk_num"], cfg["dec_blk_nums"])
    rules = bokeh_nafnet_key_rules(*dims)
    keys = bokeh_nafnet_flax_keys(*dims)
    assert {fp for fp, _ in keys.values()} == set(rules) and len(keys) == len(rules)
    for tkey, (fpath, kind) in keys.items():
        r_tkey, r_tf = rules[fpath]
        assert r_tkey == tkey, fpath
        assert KIND_OF[r_tf.__name__] == kind, fpath
    with torch.device("meta"):
        net = build_network("BokehConditionalNAFNet", dict(cfg))
    assert set(keys) == set(net.state_dict())


def _forward_pair(w, dtype, hw):
    r = np.random.default_rng(7)
    xt, cond = (r.random((2, *hw, TINY["img_channel"]), np.float32) for _ in range(2))
    tvec = np.array([7, 93], np.int32)
    lens = _lens(2, 8)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    fnet = FlaxBokeh(**TINY, dtype=jdt)
    want = np.asarray(jax.jit(lambda p, a, b, t, ln: fnet.apply(p, a, b, t, lens_info=ln))(
        unflatten(w), xt, cond, tvec, lens))
    with torch.inference_mode():
        got = port_net(w, tdt)(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(tvec),
                               tuple(torch.from_numpy(v) for v in lens))
    assert got.shape == xt.shape and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("hw", [(16, 16), (13, 19)], ids=str)
def test_forward_matches_flax(weights, hw):
    """Lens values per sample; the camera scale/shift between the FFN's
    SimpleGate and conv5 in every block.  float32: 1e-4 of max|out| (the
    NAFNet's bound); bfloat16: twice flax's own bf16-vs-f32 distance."""
    got, want = _forward_pair(weights[1], "float32", hw)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    got16, want16 = _forward_pair(weights[1], "bfloat16", hw)
    assert np.abs(got16 - want16).max() <= 2 * np.abs(want16 - want).max()


def test_lens_values_change_the_output(weights):
    net = port_net(weights[1])
    x = torch.rand(2, 16, 16, 4, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([5, 9])
    lens = tuple(torch.from_numpy(v) for v in _lens(2, 9))
    with torch.inference_mode():
        a = net(x, x * 0.5, t, lens)
        b = net(x, x * 0.5, t, (lens[0], lens[1] + 1, lens[2]))
    assert not torch.allclose(a, b)


def test_no_bokeh_level_reaches_the_naf_stack(monkeypatch):
    """Levels of 4 blocks: the bokeh block's camera modulation is not in
    K3, so each runs block by block; no kernel launches on the CPU."""

    def refuse(*a, **k):
        raise AssertionError("a bokeh level reached the NAF stack")

    monkeypatch.setattr(pnafnet, "naf_stack", refuse)
    monkeypatch.setattr(pnafnet, "naf_stack_plain", refuse)
    net = BokehConditionalNAFNet(img_channel=4, width=8, enc_blk_nums=(4, 4), middle_blk_num=4,
                                 dec_blk_nums=(4, 4)).eval()
    before = [k.launches for k in KERNELS]
    x = torch.rand(1, 16, 16, 4)
    with torch.inference_mode():
        out = net(x, x * 0.5, torch.tensor([5]), (torch.ones(1), torch.ones(1), torch.zeros(1)))
    assert torch.isfinite(out).all() and [k.launches for k in KERNELS] == before


# ------------------------------------------------------ the slice as a whole
def test_latent_chain_with_lens_matches_jax(weights):
    """encode -> noisy = latent + max_sigma * z0 -> 10 posterior steps
    (t = 10..1) through the tiny bokeh net with the lens values -> decode
    with the LQ skips -> crop, with the same weights, lens values, z0 and
    noise_seq on both sides.  float32; bound 1e-4 of max|ref|, as the
    latent dehazing chain's."""
    comp_w, naf_w = weights
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    r = np.random.default_rng(10)
    lq = r.random((2, 30, 26, 3), np.float32)
    lat_shape = (2, 16, 14, COMP["embed_dim"])
    z0 = r.standard_normal(lat_shape).astype(np.float32)
    noise_seq = r.standard_normal((STEPS, *lat_shape)).astype(np.float32)
    lens = _lens(2, 11)
    fc, fn = FlaxCompressor(**COMP), FlaxBokeh(**TINY)
    cp, npar = unflatten(comp_w), unflatten(naf_w)

    def jax_chain(img, z, ns, ln):
        latent, hidden = fc.apply(cp, img, method=fc.encode)
        out = jsamplers.reverse_posterior(ref, lambda x, m, t: fn.apply(npar, x, m, t, lens_info=ln),
                                          latent + ref.max_sigma * z, latent, steps=STEPS, noise_seq=ns)
        return fc.apply(cp, out, hidden, method=fc.decode)[:, : img.shape[1], : img.shape[2], :]

    want = np.asarray(jax.jit(jax_chain)(lq, z0, noise_seq, lens))
    comp, net = port_compressor(comp_w), port_net(naf_w)
    tlens = tuple(torch.from_numpy(v) for v in lens)
    with torch.inference_mode():
        latent, hidden = comp.encode(torch.from_numpy(lq))
        out = samplers.reverse_posterior(port, lambda x, m, t: net(x, m, t, tlens),
                                         latent + port.max_sigma * torch.from_numpy(z0), latent, steps=STEPS,
                                         noise_seq=torch.from_numpy(noise_seq))
        got = comp.decode(out, hidden)[:, :30, :26, :].numpy()
    assert got.shape == lq.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_sampler_forwards_cond_every_step(weights):
    """make_latent_sampler(...)(lq, gen, cond) is the composition above with
    the generator's draws: z0, then the chain's noise."""
    comp, net = port_compressor(weights[0]), port_net(weights[1])
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    lq = torch.rand(2, 18, 13, 3, generator=rng.generator(1, "cpu"))
    lens = tuple(torch.from_numpy(v) for v in _lens(2, 12))
    got = make_latent_sampler(sde, net, comp, mode="posterior", steps=3)(lq, rng.generator(9, "cpu"), lens)
    g = rng.generator(9, "cpu")
    with torch.inference_mode():
        latent, hidden = comp.encode(lq)
        z0 = torch.randn(latent.shape, generator=g)
        ns = torch.stack([torch.randn(latent.shape, generator=g) for _ in range(3)])
        out = samplers.reverse_posterior(sde, lambda x, m, t: net(x, m, t, lens), latent + z0 * sde.max_sigma,
                                         latent, steps=3, noise_seq=ns)
        want = comp.decode(out, hidden)[:, :18, :13, :]
    assert torch.equal(got, want)


def test_chunking_with_per_sample_generators_and_lens_is_invisible(weights):
    """Batch 4 in chunks of 2 agrees with the whole batch (1e-6: batched
    convolutions may sum in another order): each chunk gets its own rows of
    the lens values; changing chunk 1's lens leaves chunk 0 bitwise
    unchanged."""
    comp, net = port_compressor(weights[0]), port_net(weights[1])
    sde = IRSDE.create(**SDE_ARGS, device="cpu")
    lq = torch.rand(4, 16, 16, 3, generator=rng.generator(3, "cpu"))
    lens = tuple(torch.from_numpy(v) for v in _lens(4, 13))
    whole = make_latent_sampler(sde, net, comp, mode="sde", steps=2)
    chunked = make_latent_sampler(sde, net, comp, mode="sde", steps=2, chunk=2)
    a = whole(lq, rng.generators_for_seeds([1, 2, 3, 4], "cpu"), lens)
    b = chunked(lq, rng.generators_for_seeds([1, 2, 3, 4], "cpu"), lens)
    assert torch.allclose(a, b, rtol=0, atol=1e-6)
    lens2 = (lens[0].clone(), lens[1], lens[2])
    lens2[0][2:] += 3.0
    c = chunked(lq, rng.generators_for_seeds([1, 2, 3, 4], "cpu"), lens2)
    assert torch.equal(c[:2], b[:2]) and not torch.equal(c[2:], b[2:])
