"""A network that the port builds for training starts where the JAX
package's starts: for every class the registry builds, the net as the train
entry point makes it (``runners._seeded_network``) against its flax twin
from ``net.init`` on the JAX runners' inputs, tensor by tensor
through the ``utils/flax_import`` key maps.  The same keys and shapes;
every tensor that flax makes constant (biases, gains, NAFBlock scales, the
DiT's modulations and final linear map) holds that constant exactly; every
conv and dense kernel is ``lecun_normal``: a normal of std sqrt(1/fan_in)
truncated at 2 sigma' = 2 sqrt(1/fan_in) / 0.8796, in both packages; and a
fresh DiT returns exactly 0 in both.  Only distributions match: threefry's
draws cannot be reproduced."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.models import build_network as jax_build_network
from image_restoration_sde_tpu.models.modules import RandomOrLearnedSinusoidalPosEmb as FlaxFourier
from image_restoration_sde_tpu_torch import runners
from image_restoration_sde_tpu_torch.models import modules
from image_restoration_sde_tpu_torch.utils import (bokeh_nafnet_flax_keys, dit_flax_keys, latent_unet_flax_keys,
                                                   nafnet_flax_keys, state_dict_from_flax, stereo_nafnet_flax_keys,
                                                   unet_flax_keys)
from test_torch_unet import flatten

# a kernel's std within this share of sqrt(1/fan_in): the relative
# sampling error of a std over n draws of the truncated normal is below
# 1/sqrt(2n), 2.2% at n = 1024, so 10% is ~4.5 of it
STD_REL, STD_MIN_SIZE = 0.10, 1024
# max|w| against 2 sigma' computed in float64: both packages scale and
# round in float32, one ulp of slack
ULP = 1e-6
NAF = dict(width=16, enc_blk_nums=(1,), middle_blk_num=1, dec_blk_nums=(1,))
DIT = dict(hidden_size=64, depth=2, num_heads=4, patch_size=2, in_channels=4)


def _naf_keys(fn):
    return lambda s: fn(s["enc_blk_nums"], s["middle_blk_num"], s["dec_blk_nums"])


# registry name, setting, the key map of a setting, the flax init's input
# channels (None: the compressor's one-input init; "lens": the bokeh net's)
CASES = {
    "unet": ("ConditionalUNet", dict(in_nc=3, out_nc=3, nf=16, depth=2),
             lambda s: unet_flax_keys(s["depth"]), 3),
    "unet-fourier": ("ConditionalUNet", dict(in_nc=3, out_nc=3, nf=16, depth=1, random_or_learned_sinusoidal_cond=True,
                                             learned_sinusoidal_dim=16),
                     lambda s: unet_flax_keys(s["depth"], fourier=True), 3),
    "nafnet": ("ConditionalNAFNet", dict(img_channel=3, **NAF), _naf_keys(nafnet_flax_keys), 3),
    "cnafnet-local": ("CNAFNetLocal", dict(img_channel=3, train_size=[1, 3, 16, 16], **NAF),
                      _naf_keys(nafnet_flax_keys), 3),
    "stereo": ("StereoConditionalNAFNet", dict(**NAF), _naf_keys(stereo_nafnet_flax_keys), 6),
    "bokeh": ("BokehConditionalNAFNet", dict(img_channel=4, **NAF), _naf_keys(bokeh_nafnet_flax_keys), "lens"),
    "compressor": ("UNet", dict(in_ch=3, out_ch=3, ch=8, ch_mult=(1, 2), embed_dim=4),
                   lambda s: latent_unet_flax_keys(len(s["ch_mult"])), None),
    "dit": ("DiT", DIT, lambda s: dit_flax_keys(s["depth"]), 4),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(fn, *args):
    """``jax.jit(fn)(*args)``, compiled at XLA's backend optimisation level
    0: the same draws' function, compiled ~2x sooner on the CPU (the
    initialisers' threefry and erfinv take most of a net's compile)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_init(which, setting, channels) -> dict:
    """The flax twin's parameters, flattened: ``net.init`` on the inputs
    the JAX runners give it (``_init_params``; the bokeh runner's lens
    values)."""
    net = jax_build_network(which, dict(setting))
    key, t = jax.random.PRNGKey(0), jnp.array([1.0])
    if channels is None:  # the compressor: one input
        return flatten(_init(net.init, key, jnp.zeros((1, 16, 16, setting["in_ch"]))))
    x = jnp.zeros((1, 16, 16, setting["img_channel"] if channels == "lens" else channels))
    if channels == "lens":
        lens = tuple(jnp.zeros((1,)) for _ in range(3))
        return flatten(_init(lambda k, x, t: net.init(k, x, x, t, lens_info=lens), key, x, t))
    return flatten(_init(net.init, key, x, x, t))


def _check_kernel(tag, w, fan_in):
    """std within STD_REL of sqrt(1/fan_in) where the kernel is large
    enough, every element within 2 sigma'."""
    w = np.asarray(w, np.float64)
    sigma = fan_in**-0.5 / modules.TRUNCATED_STD
    if w.size >= STD_MIN_SIZE:
        assert abs(w.std() * fan_in**0.5 - 1) <= STD_REL, (tag, w.std() * fan_in**0.5)
    assert np.abs(w).max() <= 2 * sigma * (1 + ULP), (tag, np.abs(w).max() / sigma)


@pytest.mark.parametrize("case", list(CASES))
def test_fresh_net_takes_the_jax_initialisation(case):
    which, setting, key_map, channels = CASES[case]
    keys = key_map(setting)
    flat = _jax_init(which, setting, channels)
    want = state_dict_from_flax(flat, keys=keys)  # flax's tensors in the port's layout
    got = runners._seeded_network(which, dict(setting), seed=0).state_dict()
    assert set(got) == set(want)
    kernels = constants = 0
    for k, w in want.items():
        fp, kind = keys[k]
        p, w = got[k], w.numpy()
        assert tuple(p.shape) == w.shape, k
        if np.all(w == w.flat[0]):  # flax makes it a constant: the port holds it exactly
            assert torch.equal(p, torch.full_like(p, float(w.flat[0]))), (k, fp, float(w.flat[0]))
            constants += 1
        elif kind in ("conv", "dense"):
            fan_in = p[0].numel()
            assert fan_in == np.prod(flat[fp].shape[:-1]), k  # torch counts flax's fan-in
            _check_kernel(f"{k} (JAX)", flat[fp], fan_in)
            _check_kernel(f"{k} (port)", p.numpy(), fan_in)
            kernels += 1
        else:  # the Fourier features' frequencies, drawn N(0, 1) on both sides
            assert fp.endswith("sinu_pos_emb/weights") and not torch.all(p == p.flatten()[0]), k
    large = [k for k, w in want.items() if keys[k][1] in ("conv", "dense") and w.numel() >= STD_MIN_SIZE
             and not torch.all(w == w.flatten()[0])]
    assert kernels and constants and large, (kernels, constants, large)


def test_fourier_frequencies_are_standard_normal():
    """``RandomOrLearnedSinusoidalPosEmb``'s 1024 frequencies: std within
    STD_REL of 1 and mean within 4.5 standard errors of 0, in both
    packages (flax ``normal(1.0)``, torch ``randn``)."""
    flax_w = np.asarray(FlaxFourier(2048).init(jax.random.PRNGKey(0), jnp.zeros((1,)))["params"]["weights"])
    torch.manual_seed(0)
    port_w = modules.RandomOrLearnedSinusoidalPosEmb(2048).weights.detach().numpy()
    for w in (flax_w, port_w):
        assert w.shape == (1024,)
        assert abs(w.std() - 1) <= STD_REL and abs(w.mean()) <= 4.5 / 32


def test_fresh_dit_returns_zero_in_both_packages():
    """adaLN-Zero: the modulations and the final linear map start at zero,
    so a fresh DiT returns exactly 0 for any input, on the same numpy-made
    input and timesteps in both packages."""
    r = np.random.default_rng(0)
    x, cond = (r.standard_normal((2, 12, 10, DIT["in_channels"])).astype(np.float32) for _ in range(2))
    t = np.array([3.0, 71.0], np.float32)
    fnet = jax_build_network("DiT", dict(DIT))
    z = jnp.zeros((1, 16, 16, DIT["in_channels"]))
    params = _init(fnet.init, jax.random.PRNGKey(0), z, z, jnp.array([1.0]))
    want = np.asarray(jax.jit(fnet.apply)(params, x, cond, t))
    net = runners._seeded_network("DiT", dict(DIT), seed=0)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t)).numpy()
    assert want.shape == got.shape == x.shape
    assert not want.any() and not got.any()


def test_every_conv_and_dense_layer_is_the_ports_own():
    """No model file builds torch's layers directly: every conv and dense
    layer of the six families goes through ``modules.Conv2d`` /
    ``modules.Linear`` and so takes ``lecun_normal_``."""
    for case, (which, setting, _, _) in CASES.items():
        net = runners._seeded_network(which, dict(setting), seed=0)
        for name, m in net.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, torch.nn.ConvTranspose2d, torch.nn.Conv1d)):
                assert type(m) in (modules.Conv2d, modules.Linear), (case, name, type(m))


def test_the_draws_follow_the_seed():
    """``_seeded_network`` draws from its seed alone: the same seed gives
    the same tensors, another seed other kernels; the caller's global
    generator is left as it was."""
    which, setting, _, _ = CASES["nafnet"]
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    a, b, c = (runners._seeded_network(which, dict(setting), seed=s).state_dict() for s in (0, 0, 1))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["intro.weight"], c["intro.weight"])
