"""PyTorch port, Refusion score net: K3's plain version (the fused NAF stack)
against the JAX package's Pallas kernel in interpret mode and its jnp
composition; the ConditionalNAFNet key map against ``nafnet_key_rules``; the
tiny ConditionalNAFNet forward against flax with the same weights, its
4-block level fused on both sides, float32 and bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from image_restoration_sde_tpu.models import modules as jmodules
from image_restoration_sde_tpu.models.nafnet import ConditionalNAFNet as FlaxNAFNet
from image_restoration_sde_tpu.models.nafnet import NAFBlock as FlaxNAFBlock
from image_restoration_sde_tpu.ops import naf_stack as jns
from image_restoration_sde_tpu.utils.torch_import import nafnet_key_rules
from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, modules
from image_restoration_sde_tpu_torch.models import nafnet as pnafnet
from image_restoration_sde_tpu_torch.ops import KERNELS, naf_stack
from image_restoration_sde_tpu_torch.utils import nafnet_flax_keys, state_dict_from_flax
from test_torch_unet import KIND_OF, flatten, unflatten

TINY = dict(img_channel=4, width=8, enc_blk_nums=(1, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
REFUSION = dict(enc_blk_nums=(1, 1, 1, 28), middle_blk_num=1, dec_blk_nums=(1, 1, 1, 1))


def randomize(flat: dict, seed: int) -> dict:
    """Every leaf replaced by seeded numpy values: kernels ~ 1/sqrt(fan_in);
    biases and the residual scales beta/gamma (zeros at init) ~ 0.2; gains
    ~ 1 + 0.2, so every parameter shows in the output."""
    r = np.random.default_rng(seed)
    out = {}
    for path, leaf in flat.items():
        if path.endswith("/g"):
            v = 1 + 0.2 * r.standard_normal(leaf.shape)
        elif path.endswith(("bias", "beta", "gamma")):
            v = 0.2 * r.standard_normal(leaf.shape)
        else:
            v = r.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        out[path] = v.astype(np.float32)
    return out


# ------------------------------------------------------------------ K3
K, B, HW, C, TDIM = 4, 2, 8, 32, 16


class FlaxStack(nn.Module):
    @nn.compact
    def __call__(self, x, t):
        for i in range(K):
            x = FlaxNAFBlock(C, name=f"mid_block{i}")(x, t)
        return x


@pytest.fixture(scope="module")
def stack_case():
    """K flax NAFBlocks with random weights, the same blocks in the port's
    key space, an input and a time embedding."""
    r = np.random.default_rng(0)
    x = (r.standard_normal((B, HW, HW, C)) * 0.5).astype(np.float32)
    temb = r.standard_normal((B, TDIM)).astype(np.float32)
    params = jax.jit(FlaxStack().init)(jax.random.PRNGKey(0), x, temb)
    flat = randomize(flatten(params), seed=1)
    keys = {k: v for k, v in nafnet_flax_keys((), K, ()).items() if k.startswith("middle_blks.")}
    sd = state_dict_from_flax(flat, keys=keys)
    blocks = [{k.split(".", 2)[2]: v for k, v in sd.items() if k.startswith(f"middle_blks.{i}.")} for i in range(K)]
    return x, temb, unflatten(flat), blocks


def test_stack_middle_params_matches_jax(stack_case):
    """The port's stacked layout from torch-layout blocks equals the JAX
    one from the flax tree: weights exactly, tmod to float32 rounding
    (1e-6 absolute on O(1) values)."""
    x, temb, params, blocks = stack_case
    want = jns.stack_middle_params(params, jnp.asarray(temb), K)
    got = naf_stack.stack_middle_params(blocks, torch.from_numpy(temb))
    assert set(got) == set(want) == set(naf_stack.WEIGHT_KEYS)
    for k in naf_stack.WEIGHT_KEYS:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32, k
        tol = 1e-6 if k == "tmod" else 0
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=tol, err_msg=k)


def test_naf_stack_plain_matches_pallas_interpret(stack_case):
    """K=4, B=2, 8x8, C=32, eps 1e-5, both sides' stacked parameters from
    their own stack_middle_params.  Bound 2e-5 absolute, the JAX package's
    own bound between its kernel and the flax blocks (tests/test_ops.py)."""
    x, temb, params, blocks = stack_case
    stacked = jns.stack_middle_params(params, jnp.asarray(temb), K)
    pallas = np.asarray(jax.jit(lambda a, s: jns.naf_stack(a, s, 1e-5, True, True))(jnp.asarray(x), stacked))
    composed = np.asarray(jax.jit(lambda a, s: jns._jnp_naf_stack(a, s, 1e-5))(jnp.asarray(x), stacked))
    got = naf_stack.naf_stack_plain(torch.from_numpy(x),
                                    naf_stack.stack_middle_params(blocks, torch.from_numpy(temb)), 1e-5)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(got.numpy() - pallas).max() <= 2e-5
    assert np.abs(got.numpy() - composed).max() <= 2e-5


def test_naf_stack_plain_per_sample_tmod_matches_pallas(monkeypatch):
    """B=4, K=2 with a per-sample tmod, the Pallas kernel forced to one
    sample per batch chunk (as tests/test_ops.py does).  Bound 2e-5."""
    Kb, Bb = 2, 4
    r = np.random.default_rng(7)
    x = (r.standard_normal((Bb, 8, 8, C)) * 0.2).astype(np.float32)
    shapes = {
        "w1": (Kb, C, 2 * C), "b1": (Kb, 1, 2 * C), "wdw": (Kb, 3, 3, 2 * C), "b2": (Kb, 1, 2 * C),
        "wsca": (Kb, C, C), "bsca": (Kb, 1, C), "w3": (Kb, C, C), "b3": (Kb, 1, C),
        "w4": (Kb, C, 2 * C), "b4": (Kb, 1, 2 * C), "w5": (Kb, C, C), "b5": (Kb, 1, C),
        "g1": (Kb, 1, C), "g2": (Kb, 1, C), "beta": (Kb, 1, C), "gamma": (Kb, 1, C),
        "tmod": (Kb, Bb, 4 * C),
    }
    stacked = {k: (r.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    monkeypatch.setattr(jns, "_CHUNK_VMEM_BYTES", 8 * 8 * C * 4)
    assert jns.batch_chunk(x.shape) == 1
    want = np.asarray(jax.jit(lambda a, s: jns.naf_stack(a, s, 1e-5, True, True))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in stacked.items()}))
    got = naf_stack.naf_stack_plain(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in stacked.items()}, 1e-5)
    assert np.abs(got.numpy() - want).max() <= 2e-5


def test_naf_stack_plain_rounds_each_block_to_the_input_dtype(stack_case):
    """bf16 in, bf16 out, and each block's output rounded: running the
    blocks one call at a time gives the same bits."""
    x, temb, _, blocks = stack_case
    stacked = naf_stack.stack_middle_params(blocks, torch.from_numpy(temb))
    xb = torch.from_numpy(x).bfloat16()
    whole = naf_stack.naf_stack_plain(xb, stacked, 1e-3)
    step = xb
    for i in range(K):
        step = naf_stack.naf_stack_plain(step, {k: v[i : i + 1] for k, v in stacked.items()}, 1e-3)
    assert whole.dtype == torch.bfloat16 and torch.equal(whole, step)


def test_naf_stack_dispatch_on_the_cpu(stack_case):
    x, temb, _, blocks = stack_case
    before = [k.launches for k in KERNELS]
    xt, tt = torch.from_numpy(x), torch.from_numpy(temb)
    got = naf_stack.naf_stack(xt, blocks, tt, 1e-5)
    assert torch.equal(got, naf_stack.naf_stack_plain(xt, naf_stack.stack_middle_params(blocks, tt), 1e-5))
    assert [k.launches for k in KERNELS] == before
    with pytest.raises(ValueError, match="CUDA"):
        naf_stack.naf_stack_cuda(xt, blocks, naf_stack.time_modulation(blocks, tt), 1e-5)


# ------------------------------------------------------- modules helpers
@pytest.mark.parametrize("hw", [(4, 6), (3, 5)], ids=str)
def test_pixel_shuffle_and_zero_padding_match_jax(hw):
    r = np.random.default_rng(3)
    x = r.standard_normal((2, *hw, 12)).astype(np.float32)
    want = np.asarray(jmodules.pixel_shuffle(jnp.asarray(x), 2))
    got = modules.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    for mode in ("zeros", "reflect"):
        want = np.asarray(jmodules.check_image_size(jnp.asarray(x), 4, mode=mode))
        np.testing.assert_array_equal(modules.check_image_size(torch.from_numpy(x), 4, mode=mode).numpy(), want)
    np.testing.assert_array_equal(modules.simple_gate(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jmodules.simple_gate(jnp.asarray(x))))


# ------------------------------------------------------------ the net
@pytest.mark.parametrize("cfg", [TINY, dict(REFUSION, width=8, img_channel=8)], ids=["tiny", "refusion"])
def test_key_map_matches_nafnet_key_rules(cfg):
    dims = (cfg["enc_blk_nums"], cfg["middle_blk_num"], cfg["dec_blk_nums"])
    rules = nafnet_key_rules(*dims)
    keys = nafnet_flax_keys(*dims)
    assert {fp for fp, _ in keys.values()} == set(rules) and len(keys) == len(rules)
    for tkey, (fpath, kind) in keys.items():
        r_tkey, r_tf = rules[fpath]
        assert r_tkey == tkey, fpath
        assert KIND_OF[r_tf.__name__] == kind, fpath
    assert set(keys) == set(ConditionalNAFNet(**cfg).state_dict())


@pytest.fixture(scope="module")
def tiny_weights():
    fnet = FlaxNAFNet(**TINY)
    x = jnp.zeros((1, 16, 16, TINY["img_channel"]))
    return randomize(flatten(jax.jit(fnet.init)(jax.random.PRNGKey(0), x, x, jnp.array([1.0]))), seed=2)


def port_net(weights, dtype=torch.float32) -> ConditionalNAFNet:
    net = ConditionalNAFNet(**TINY, dtype=dtype)
    keys = nafnet_flax_keys(TINY["enc_blk_nums"], TINY["middle_blk_num"], TINY["dec_blk_nums"])
    net.load_state_dict(state_dict_from_flax(weights, keys=keys))
    return net.eval()


def _forward_pair(weights, dtype, hw, monkeypatch):
    """The port and flax forwards of the same weights and inputs; the fused
    4-block level runs once on each side (flax: the Pallas kernel in
    interpret mode)."""
    monkeypatch.setenv("IRSDE_NAF_FUSE_INTERPRET", "1")
    calls = {"jax": 0, "port": 0}
    j_orig, p_orig = jns.naf_stack, pnafnet.naf_stack

    def j_count(*a):
        calls["jax"] += 1
        return j_orig(*a)

    def p_count(*a):
        calls["port"] += 1
        return p_orig(*a)

    monkeypatch.setattr(jns, "naf_stack", j_count)
    monkeypatch.setattr(pnafnet, "naf_stack", p_count)
    r = np.random.default_rng(4)
    xt, cond = (r.random((2, *hw, TINY["img_channel"]), np.float32) for _ in range(2))
    tvec = np.array([7, 93], np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax.jit(FlaxNAFNet(**TINY, dtype=jdt).apply)(unflatten(weights), xt, cond, tvec))
    with torch.inference_mode():
        got = port_net(weights, tdt)(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(tvec))
    assert calls == {"jax": 1, "port": 1}
    assert got.shape == (2, *hw, TINY["img_channel"]) and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("hw", [(16, 16), (13, 19)], ids=str)
def test_forward_matches_flax_f32(tiny_weights, hw, monkeypatch):
    """Bound 1e-4 of max|out|: float32 convolutions and products sum in
    another order through ~20 layers (13x19 zero-pads to 16x20)."""
    got, want = _forward_pair(tiny_weights, "float32", hw, monkeypatch)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("hw", [(16, 16), (13, 19)], ids=str)
def test_forward_matches_flax_bf16(tiny_weights, hw, monkeypatch):
    """Both nets compute in bfloat16 with float32 parameters (the fused
    level in float32), but round at different places; bound: twice the
    flax bf16 output's own distance from the flax float32 output."""
    got, want = _forward_pair(tiny_weights, "bfloat16", hw, monkeypatch)
    _, f32 = _forward_pair(tiny_weights, "float32", hw, monkeypatch)
    assert np.abs(got - want).max() <= 2 * np.abs(want - f32).max()


def test_fused_level_matches_the_blocks_one_by_one(tiny_weights, monkeypatch):
    """float32: the fused stack computes the blocks' own function (bound
    1e-5 of max|out|, float32 rounding of the same math)."""
    net = port_net(tiny_weights)
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.random((2, 16, 16, TINY["img_channel"]), np.float32))
    t = torch.tensor([3, 50])
    with torch.inference_mode():
        fused = net(x, x * 0.5, t)
        monkeypatch.setattr(pnafnet, "FUSE_MIN_BLOCKS", 100)
        blocks = net(x, x * 0.5, t)
    assert np.abs((fused - blocks).numpy()).max() <= 1e-5 * blocks.abs().max().item()


def test_fusion_needs_a_width_the_kernel_takes(monkeypatch):
    """Width 12, enc (4, 4): the 4-block level at 12 channels (not a
    multiple of 8, which K3 needs) runs block by block and stays out of
    ``fused_param_names``; the 4-block level at 24 channels fuses.  The
    float32 forward agrees with the plain path's within 1e-5 of max|out|."""
    from image_restoration_sde_tpu_torch.models import init_params_

    cfg = dict(img_channel=3, width=12, enc_blk_nums=(4, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
    net, plain = (ConditionalNAFNet(**cfg, plain=p).eval() for p in (False, True))
    init_params_(net, torch.Generator().manual_seed(0))
    plain.load_state_dict(net.state_dict())
    names = net.fused_param_names()
    assert names == plain.fused_param_names()
    assert len(names) == 4 * len(pnafnet._BLOCK_KEYS) and all(n.startswith("encoders.1.") for n in names)
    widths = []
    p_orig = pnafnet.naf_stack

    def record(x, *a):
        widths.append(x.shape[-1])
        return p_orig(x, *a)

    monkeypatch.setattr(pnafnet, "naf_stack", record)
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(7))
    t = torch.tensor([3, 50])
    with torch.inference_mode():
        got, ref = net(x, x * 0.5, t), plain(x, x * 0.5, t)
    assert widths == [24]
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_kernel_sites_get_contiguous_rows(tiny_weights, monkeypatch):
    """Every K1 and K3 call of a forward gets contiguous (pixels, C) rows,
    which the CUDA wrappers require (they raise rather than copy)."""
    seen = []

    def check(fn):
        def wrapped(x, *a):
            seen.append(x.is_contiguous())
            return fn(x, *a)

        return wrapped

    monkeypatch.setattr(modules, "channel_layernorm", check(modules.channel_layernorm))
    monkeypatch.setattr(pnafnet, "naf_stack", check(pnafnet.naf_stack))
    x = torch.rand(2, 13, 19, TINY["img_channel"])
    with torch.inference_mode():
        port_net(tiny_weights, torch.bfloat16)(x, x, torch.tensor([1, 2]))
    assert len(seen) == 2 * 4 + 1 and all(seen)


def test_cast_params_weights_reach_the_fused_level_as_float32(tiny_weights, monkeypatch):
    """``make_noise_fn`` with bf16 parameters: the fused level reads float32
    tensors holding the bf16-cast values, cast once (the same tensors on
    every forward, so nothing is copied per forward and the kernel's
    pointer table stays put); the output moves off the float32-weight
    output."""
    from image_restoration_sde_tpu_torch.sampling import make_noise_fn

    seen = []

    def record(x, blocks, *a):
        seen.append([dict(b) for b in blocks])
        return p_orig(x, blocks, *a)

    p_orig = pnafnet.naf_stack
    monkeypatch.setattr(pnafnet, "naf_stack", record)
    net = port_net(tiny_weights)
    x = torch.rand(1, 16, 16, TINY["img_channel"], generator=torch.Generator().manual_seed(6))
    noise_fn = make_noise_fn(net, torch.bfloat16)
    with torch.inference_mode():
        cast = noise_fn(x, x, torch.tensor([4]))
        noise_fn(x, x, torch.tensor([9]))
        ref = net(x, x, torch.tensor([4]))
    assert len(seen) == 3 and len(seen[0]) == 4
    for first, again, own in zip(*seen):
        for k, v in first.items():
            assert v.dtype == torch.float32 and v is again[k]
            assert torch.equal(v, own[k].bfloat16().float())
    assert torch.isfinite(cast).all() and not torch.equal(cast, ref)
    assert (cast - ref).abs().max().item() <= 0.05 * ref.abs().max().item()


def test_unconditional_forward_matches_flax(monkeypatch):
    """``conditional=False`` (the denoising SDE's variant, no LQ concat):
    the flax and port nets on the same weights, ``forward(x, None, t)``,
    the 4-block level fused on both sides, float32.  Bound 1e-4 of
    max|out|, as the conditional net's."""
    monkeypatch.setenv("IRSDE_NAF_FUSE_INTERPRET", "1")
    cfg = dict(TINY, img_channel=3)
    fnet = FlaxNAFNet(**cfg, conditional=False)
    x0 = jnp.zeros((1, 16, 16, 3))
    weights = randomize(flatten(jax.jit(lambda k, x: fnet.init(k, x, None, jnp.array([1.0])))(
        jax.random.PRNGKey(0), x0)), seed=5)
    net = ConditionalNAFNet(**cfg, conditional=False)
    keys = nafnet_flax_keys(cfg["enc_blk_nums"], cfg["middle_blk_num"], cfg["dec_blk_nums"])
    net.load_state_dict(state_dict_from_flax(weights, keys=keys))
    assert net.intro.weight.shape[1] == 3
    r = np.random.default_rng(8)
    x = r.random((2, 13, 19, 3), np.float32)
    tvec = np.array([40, 900], np.int32)
    want = np.asarray(jax.jit(lambda p, a, t: fnet.apply(p, a, None, t))(unflatten(weights), x, tvec))
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x), None, torch.from_numpy(tvec)).numpy()
    assert got.shape == x.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
