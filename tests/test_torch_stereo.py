"""PyTorch port, stereo super-resolution: SCAM against the flax module at
map sides that are not multiples of 4, its resize rules, the stereo
NAFNet's key map against ``stereo_nafnet_key_rules``, its forward against
flax (float32 and bfloat16) and a 10-step posterior chain against the JAX
package, and that no stereo level reaches the fused NAF stack (K3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_sde_tpu.models.stereo_nafnet import SCAM as FlaxSCAM
from image_restoration_sde_tpu.models.stereo_nafnet import StereoConditionalNAFNet as FlaxStereo
from image_restoration_sde_tpu.utils.torch_import import stereo_nafnet_key_rules
from image_restoration_sde_tpu_torch.models import StereoConditionalNAFNet, build_network, modules
from image_restoration_sde_tpu_torch.models import nafnet as pnafnet
from image_restoration_sde_tpu_torch.models.stereo_nafnet import SCAM
from image_restoration_sde_tpu_torch.ops import KERNELS
from image_restoration_sde_tpu_torch.utils import state_dict_from_flax, stereo_nafnet_flax_keys
from test_torch_nafnet import randomize
from test_torch_unet import KIND_OF, flatten, unflatten

TINY = dict(width=8, enc_blk_nums=(1, 1), middle_blk_num=1, dec_blk_nums=(1, 1))
CONFIG = dict(width=64, enc_blk_nums=(1, 1, 1, 28), middle_blk_num=1, dec_blk_nums=(1, 1, 1, 1))
_KIND = {"g": "norm", "beta": "norm", "gamma": "norm", "kernel": "conv", "bias": "ident"}


# ------------------------------------------------------------------ SCAM
def test_nearest_rule_is_the_half_pixel_one():
    """jax.image.resize "nearest" samples at half-pixel centres: torch's
    "nearest-exact", not its legacy "nearest", which differs from 4 -> 18
    on (the upstream torch SCAM resizes with "nearest")."""
    for n_in, n_out in [(4, 18), (6, 26), (2, 9), (3, 13), (4, 16)]:
        src = np.arange(n_in, dtype=np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(src), (n_out,), "nearest"))
        assert np.array_equal(src[modules.nearest_indices(n_in, n_out)], want)
        exact = F.interpolate(torch.from_numpy(src)[None, None], size=n_out, mode="nearest-exact")
        assert np.array_equal(exact.numpy().ravel(), want)
    legacy = F.interpolate(torch.arange(4.0)[None, None], size=18, mode="nearest").numpy().ravel()
    assert not np.array_equal(legacy, np.asarray(jax.image.resize(jnp.arange(4.0), (18,), "nearest")))


def test_bicubic_weights_match_the_jax_package_and_torch():
    from image_restoration_sde_tpu.models.modules import bicubic_resize_weights as j_weights

    for n_in in (18, 26, 9, 13, 128):
        w = modules.bicubic_resize_weights(n_in, max(n_in // 4, 1))
        assert np.array_equal(w, j_weights(n_in, max(n_in // 4, 1)))
    x = torch.rand(1, 1, 18, 26, generator=torch.Generator().manual_seed(0))
    want = F.interpolate(x, size=(4, 6), mode="bicubic", align_corners=False)
    got = torch.from_numpy(modules.bicubic_resize_weights(18, 4)) @ x[0, 0] @ torch.from_numpy(
        modules.bicubic_resize_weights(26, 6)).T
    assert (got - want[0, 0]).abs().max().item() <= 1e-6


def _scam_pair(C, hw, seed):
    fs = FlaxSCAM(C)
    x = np.random.default_rng(seed).standard_normal((4, *hw, C)).astype(np.float32)
    w = randomize(flatten(jax.jit(fs.init)(jax.random.PRNGKey(0), x)), seed=seed)
    keys = {}
    for path in w:
        *mods, leaf = path.split("/")
        keys[".".join(mods + ["weight" if leaf == "kernel" else leaf])] = (path, _KIND[leaf])
    port = SCAM(C)
    port.load_state_dict(state_dict_from_flax(w, keys=keys))
    want = np.asarray(jax.jit(fs.apply)(unflatten(w), x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return got, want


@pytest.mark.parametrize("hw", [(18, 26), (9, 13), (36, 52), (3, 5)], ids=str)
def test_scam_matches_flax(hw):
    """Sides that are not multiples of 4, so the bicubic 1/4 and the nearest
    resize back up both matter; beta and gamma off zero.  float32, bound
    1e-5 of max|out| (the two resizes, projections and attention sum in
    another order)."""
    got, want = _scam_pair(16, hw, seed=sum(hw))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------------------- the net
@pytest.mark.parametrize("cfg", [TINY, CONFIG], ids=["tiny", "stereo-sr"])
def test_key_map_matches_stereo_nafnet_key_rules(cfg):
    dims = (cfg["enc_blk_nums"], cfg["middle_blk_num"], cfg["dec_blk_nums"])
    rules = stereo_nafnet_key_rules(*dims)
    keys = stereo_nafnet_flax_keys(*dims)
    assert {fp for fp, _ in keys.values()} == set(rules) and len(keys) == len(rules)
    for tkey, (fpath, kind) in keys.items():
        r_tkey, r_tf = rules[fpath]
        assert r_tkey == tkey, fpath
        assert KIND_OF[r_tf.__name__] == kind, fpath
    with torch.device("meta"):
        net = build_network("StereoConditionalNAFNet", dict(cfg))
    assert set(keys) == set(net.state_dict())


@pytest.fixture(scope="module")
def tiny_weights():
    x = jnp.zeros((1, 16, 16, 6))
    return randomize(flatten(jax.jit(FlaxStereo(**TINY).init)(jax.random.PRNGKey(0), x, x, jnp.array([1.0]))), seed=3)


def port_net(weights, dtype=torch.float32) -> StereoConditionalNAFNet:
    net = StereoConditionalNAFNet(**TINY, dtype=dtype)
    keys = stereo_nafnet_flax_keys(TINY["enc_blk_nums"], TINY["middle_blk_num"], TINY["dec_blk_nums"])
    net.load_state_dict(state_dict_from_flax(weights, keys=keys))
    return net.eval()


def _forward_pair(weights, dtype, hw):
    r = np.random.default_rng(4)
    xt, cond = (r.random((2, *hw, 6), np.float32) for _ in range(2))
    tvec = np.array([7, 93], np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax.jit(FlaxStereo(**TINY, dtype=jdt).apply)(unflatten(weights), xt, cond, tvec))
    with torch.inference_mode():
        got = port_net(weights, tdt)(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(tvec))
    assert got.shape == (2, *hw, 6) and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("hw", [(36, 52), (33, 50)], ids=str)
def test_forward_matches_flax(tiny_weights, hw):
    """[L; R] doubled batch, zero padding to 4 (33x50 -> 36x52: SCAM at
    36x52, 18x26 and 9x13), halves back on channels.  float32: 1e-4 of
    max|out| (the NAFNet's bound: another summation order through ~25
    layers); bfloat16: twice flax's own bf16-vs-f32 distance."""
    got, want = _forward_pair(tiny_weights, "float32", hw)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    got16, want16 = _forward_pair(tiny_weights, "bfloat16", hw)
    assert np.abs(got16 - want16).max() <= 2 * np.abs(want16 - want).max()


def test_no_stereo_level_reaches_the_naf_stack(monkeypatch):
    """A 4-block level, which ConditionalNAFNet would fuse: the stereo net
    runs it block by block (a SCAM follows each block), so neither the K3
    wrapper nor its plain version is called and no kernel launches."""

    def refuse(*a, **k):
        raise AssertionError("a stereo level reached the NAF stack")

    monkeypatch.setattr(pnafnet, "naf_stack", refuse)
    monkeypatch.setattr(pnafnet, "naf_stack_plain", refuse)
    net = StereoConditionalNAFNet(width=8, enc_blk_nums=(1, 4), middle_blk_num=4, dec_blk_nums=(4, 1)).eval()
    before = [k.launches for k in KERNELS]
    x = torch.rand(1, 16, 20, 6)
    with torch.inference_mode():
        assert torch.isfinite(net(x, x * 0.5, torch.tensor([5]))).all()
    assert [k.launches for k in KERNELS] == before


def test_kernel_sites_get_contiguous_aligned_rows(tiny_weights, monkeypatch):
    """Every K1 call of a forward (the blocks' norms and SCAM's norm_l and
    norm_r on the 1/4 maps) gets contiguous, 16-byte aligned (pixels, C)
    rows, which the CUDA wrapper requires: 4 per block."""
    seen = []

    def check(x, *a):
        seen.append(x.is_contiguous() and x.data_ptr() % 16 == 0)
        return modules.channel_layernorm_plain(x, *a)

    monkeypatch.setattr(modules, "channel_layernorm", check)
    with torch.inference_mode():
        port_net(tiny_weights)(torch.rand(2, 33, 50, 6), torch.rand(2, 33, 50, 6), torch.tensor([3, 9]))
    assert len(seen) == 4 * 5 and all(seen)


def test_posterior_chain_matches_jax(tiny_weights):
    """noisy = lq + max_sigma * z0, then 10 posterior steps (t = 10..1)
    through the tiny stereo net, with the same weights, z0 and noise_seq
    on both sides.  float32; bound 1e-4 of max|ref|, as the latent chains'
    (the nets' float32 rounding differences through 10 O(1) steps)."""
    from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
    from image_restoration_sde_tpu.sde import samplers as jsamplers
    from image_restoration_sde_tpu_torch.sde import IRSDE, samplers

    args = dict(max_sigma=50.0, T=100, schedule="cosine", eps=0.005)
    j, p = JIRSDE.create(**args), IRSDE.create(**args, device="cpu")
    r = np.random.default_rng(8)
    lq = r.random((1, 18, 26, 6), np.float32)
    z0 = r.standard_normal(lq.shape).astype(np.float32)
    noise_seq = r.standard_normal((10, *lq.shape)).astype(np.float32)
    fnet, params = FlaxStereo(**TINY), unflatten(tiny_weights)
    want = np.asarray(jax.jit(lambda a, z, ns: jsamplers.reverse_posterior(
        j, lambda x, m, t: fnet.apply(params, x, m, t), a + j.max_sigma * z, a, steps=10, noise_seq=ns))(
        lq, z0, noise_seq))
    net = port_net(tiny_weights)
    x = torch.from_numpy(lq)
    with torch.inference_mode():
        got = samplers.reverse_posterior(p, net, x + p.max_sigma * torch.from_numpy(z0), x, steps=10,
                                         noise_seq=torch.from_numpy(noise_seq)).numpy()
    assert got.shape == lq.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
