"""PyTorch port, the DiT path: K4's plain versions (un-tiled, and tiled as
the kernel) against the JAX package's flash attention (Pallas in interpret
mode) and its einsum reference; the
DiT against the flax DiT; its key map against ``dit_key_rules``; a 10-step
latent chain through the compressor and a tiny DiT against the JAX
composition; the network registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.models.dit import DiT as FlaxDiT
from image_restoration_sde_tpu.models.latent_unet import UNet as FlaxCompressor
from image_restoration_sde_tpu.ops.flash_attention import _flash_forward, _ref_mha
from image_restoration_sde_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from image_restoration_sde_tpu.sampling import cast_f32_leaves
from image_restoration_sde_tpu.sde import IRSDE as JIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu.utils.torch_import import dit_key_rules
from image_restoration_sde_tpu_torch.models import DiT, UNet, build_network, dit
from image_restoration_sde_tpu_torch.models.registry import available
from image_restoration_sde_tpu_torch.ops import flash_attention as FA
from image_restoration_sde_tpu_torch.sampling import make_noise_fn
from image_restoration_sde_tpu_torch.sde import IRSDE, samplers
from image_restoration_sde_tpu_torch.utils import dit_flax_keys, latent_unet_flax_keys, state_dict_from_flax
from test_torch_cuda import FLASH_FLIP_SHARE, flash_bf16_agreement
from test_torch_nafnet import randomize
from test_torch_unet import KIND_OF, flatten, unflatten

TINY = dict(hidden_size=64, depth=2, num_heads=4, patch_size=2, in_channels=4)
COMP = dict(in_ch=3, out_ch=3, ch=4, ch_mult=(1, 2), embed_dim=4)
SDE_ARGS = dict(max_sigma=50.0, T=100, schedule="cosine", eps=0.005)
STEPS = 10


def _qkv(shape, dtype, seed):
    """q, k, v ~ N(0, 1.5^2) from numpy, rounded to ``dtype`` on both sides."""
    r = np.random.default_rng(seed)
    arrs = [(1.5 * r.standard_normal(shape)).astype(np.float32) for _ in range(3)]
    port = [torch.from_numpy(a).to(dtype) for a in arrs]
    return port, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
                  for t in port]


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("B,N,H,D,dtype,bound", [
    (2, 512, 4, 64, torch.float32, 1e-5),
    (1, 256, 3, 64, torch.float32, 1e-5),
    (1, 256, 8, 32, torch.float32, 1e-5),
    (1, 256, 4, 64, torch.bfloat16, 2e-2),
], ids=str)
def test_flash_plain_matches_pallas_kernel(B, N, H, D, dtype, bound):
    """The cases of the JAX package's own flash tests, its Pallas kernel in
    interpret mode.  float32: 1e-5 of max|ref| (sums in another order);
    bfloat16: 2e-2 (p rounds at the block's running max there, at the row
    max here, and the output rounds to bf16)."""
    (q, k, v), (jq, jk, jv) = _qkv((B, N, H, D), dtype, seed=N + H + D)
    scale = D**-0.5
    want = jax.jit(lambda a, b, c: jax_flash_mha(a, b, c, scale, True))(jq, jk, jv)
    got = FA.flash_mha_plain(q, k, v, scale)
    assert got.dtype == dtype and got.shape == (B, N, H, D)
    assert _rel_err(got, want) <= bound


@pytest.mark.parametrize("N", [35, 200])
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)], ids=str)
def test_flash_plain_matches_einsum_reference_at_ragged_n(N, dtype, bound):
    """Token counts the Pallas kernel cannot block (no divisor of 128);
    against ``_ref_mha``, which divides before it rounds: float32 1e-5 of
    max|ref|, bfloat16 2e-2."""
    (q, k, v), (jq, jk, jv) = _qkv((2, N, 4, 64), dtype, seed=N)
    want = _ref_mha(jq, jk, jv, 0.125)
    assert _rel_err(FA.flash_mha_plain(q, k, v, 0.125), want) <= bound


@pytest.mark.parametrize("B,N,H,D,tile", [
    pytest.param(1, 256, 4, 64, 64, id="1-256-4-64"),
    pytest.param(2, 192, 2, 72, 64, id="2-192-2-72"),
    pytest.param(1, 256, 4, 64, 128, id="1-256-4-64-tile128"),
    pytest.param(2, 384, 2, 64, 128, id="2-384-2-64-tile128"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_tiled_plain_matches_pallas_kernel_at_its_tiles(B, N, H, D, tile, dtype):
    """``flash_mha_tiled_plain`` at ``tile`` keys per tile against the
    Pallas kernel in interpret mode at bq = bk = tile: the same order of
    operations, p rounded at each tile's running max.  The CUDA kernel's
    tiles are ``KEY_TILE``: 128 keys at head dim 64, 64 at 72 (the
    default ``block``).  float32: 1e-5 of max|ref|; bfloat16:
    ``flash_bf16_agreement`` (float32 sums and exp in another order may
    flip the rounding of a p), which the un-tiled plain version, rounding p
    at the row max, fails."""
    (q, k, v), (jq, jk, jv) = _qkv((B, N, H, D), dtype, seed=N + D)
    scale = D**-0.5
    want = jax.jit(lambda a, b, c: _flash_forward(a, b, c, scale, bq=tile, bk=tile, interpret=True))(jq, jk, jv)
    got = FA.flash_mha_tiled_plain(q, k, v, scale, block=tile)
    if tile == FA.KEY_TILE[D]:
        assert torch.equal(got, FA.flash_mha_tiled_plain(q, k, v, scale))  # the default follows the kernel
    assert got.dtype == dtype and got.shape == (B, N, H, D)
    if dtype == torch.float32:
        assert _rel_err(got, want) <= 1e-5
    else:
        want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))).to(dtype)
        share, worst = flash_bf16_agreement(got, want, q, k, v, scale)
        assert share <= FLASH_FLIP_SHARE and worst <= 1, (share, worst)
        # the bound tells where p is rounded: at the row max it fails
        assert flash_bf16_agreement(FA.flash_mha_plain(q, k, v, scale), want, q, k, v, scale)[0] > FLASH_FLIP_SHARE


@pytest.mark.parametrize("N", [35, 200])
def test_tiled_plain_matches_plain_in_f32_at_ragged_n(N):
    """In float32 no p is rounded, so the tiled and un-tiled versions are
    the same function up to float32 sums: 1e-5 of max|ref|; a ragged last
    tile included."""
    (q, k, v), _ = _qkv((2, N, 4, 64), torch.float32, seed=N + 1)
    want = FA.flash_mha_plain(q, k, v, 0.125)
    got = FA.flash_mha_tiled_plain(q, k, v, 0.125)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_flash_entry_runs_the_plain_version_on_the_cpu():
    (q, k, v), _ = _qkv((1, 40, 2, 64), torch.float32, seed=1)
    assert torch.equal(FA.flash_mha(q, k, v, 0.125), FA.flash_mha_plain(q, k, v, 0.125))
    with pytest.raises(ValueError, match="not a CUDA device"):
        FA.flash_mha_cuda(q, k, v, 0.125)


# ------------------------------------------------------------------ DiT
@pytest.fixture(scope="module")
def tiny_weights():
    z = jnp.zeros((1, 16, 16, TINY["in_channels"]))
    flat = flatten(jax.jit(FlaxDiT(**TINY).init)(jax.random.PRNGKey(0), z, z, jnp.array([1.0])))
    # flax zero-initialises adaLN and the final layer: randomize every leaf
    return randomize(flat, seed=11)


def port_dit(w, **kw) -> DiT:
    net = DiT(**TINY, **kw)
    net.load_state_dict(state_dict_from_flax(w, keys=dit_flax_keys(TINY["depth"])))
    return net.eval()


def test_key_map_matches_dit_key_rules():
    rules = dit_key_rules(2)
    keys = dit_flax_keys(2)
    assert {fp for fp, _ in keys.values()} == set(rules) and len(keys) == len(rules)
    for tkey, (fpath, kind) in keys.items():
        r_tkey, r_tf = rules[fpath]
        assert r_tkey == tkey, fpath
        assert KIND_OF[r_tf.__name__] == kind, fpath
    assert set(keys) == set(DiT(**TINY).state_dict())
    with torch.device("meta"):
        big = build_network("DiT_L_2", {"in_channels": 8})
    assert len(dit_flax_keys(24)) == len(dit_key_rules(24)) == 250
    assert set(big.state_dict()) == set(dit_flax_keys(24))


def _dit_inputs(hw, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, *hw, TINY["in_channels"])).astype(np.float32)
    cond = r.standard_normal((2, *hw, TINY["in_channels"])).astype(np.float32)
    return x, cond, np.array([3.0, 71.0], np.float32)


def _flax_dit(w, dtype, inputs, cast=None):
    params = unflatten(w)
    if cast is not None:
        params = cast_f32_leaves(params, cast)
    return np.asarray(jax.jit(FlaxDiT(**TINY, dtype=dtype).apply)(params, *inputs))


@pytest.mark.parametrize("hw", [(10, 14), (11, 13), (16, 16)], ids=str)
def test_dit_matches_flax_f32(tiny_weights, hw):
    """10x14 and 16x16 are patch multiples, 11x13 reflect-pads to 12x14.
    Bound 1e-5 of max|ref|: float32 sums in another order through two
    blocks (flax's LayerNorm takes E[x^2] - mean^2, F.layer_norm the
    centered variance)."""
    inputs = _dit_inputs(hw, seed=hw[0])
    want = _flax_dit(tiny_weights, jnp.float32, inputs)
    with torch.inference_mode():
        got = port_dit(tiny_weights)(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape == (2, *hw, TINY["in_channels"]) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("hw", [(11, 13), (16, 16)], ids=str)
@pytest.mark.parametrize("cast", [False, True], ids=["f32-params", "cast-params"])
def test_dit_matches_flax_bf16(tiny_weights, hw, cast):
    """bf16 compute with float32 parameters, and with the parameters cast to
    bf16 (``make_noise_fn`` / ``cast_f32_leaves``: the timestep MLP then
    computes in float32 on the rounded weights).  The two sides round at
    other places (below 2048 tokens flax divides by the softmax sum before
    rounding p, the port after), so the bound is twice the flax bf16
    result's own distance from flax float32, on the same weights."""
    inputs = _dit_inputs(hw, seed=7)
    cast_to = (jnp.bfloat16, torch.bfloat16) if cast else (None, None)
    want = _flax_dit(tiny_weights, jnp.bfloat16, inputs, cast_to[0])
    f32 = _flax_dit(tiny_weights, jnp.float32, inputs, cast_to[0])
    net = port_dit(tiny_weights, dtype=torch.bfloat16)
    fn = make_noise_fn(net, cast_to[1])
    with torch.inference_mode():
        got = fn(*map(torch.from_numpy, inputs)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2 * np.abs(want - f32).max()
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_attention_takes_strided_views_of_the_packed_qkv(tiny_weights, monkeypatch):
    """Every attention site gets q, k, v as views into the qkv product
    (token stride 3 x hidden), never copies; once per block."""
    seen = []

    def spy(q, k, v, scale):
        seen.append((q.stride(1), k.data_ptr() - q.data_ptr(), v.data_ptr() - k.data_ptr(), scale))
        return FA.flash_mha_plain(q, k, v, scale)

    monkeypatch.setattr(dit, "flash_mha", spy)
    with torch.inference_mode():
        port_dit(tiny_weights)(*map(torch.from_numpy, _dit_inputs((8, 8), seed=2)))
    hidden, dh = TINY["hidden_size"], TINY["hidden_size"] // TINY["num_heads"]
    assert seen == [(3 * hidden, hidden * 4, hidden * 4, dh**-0.5)] * TINY["depth"]


# ------------------------------------------------------ the slice as a whole
@pytest.fixture(scope="module")
def compressor_weights():
    fc = FlaxCompressor(**COMP)
    flat = flatten(jax.jit(fc.init)(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3))))
    return randomize(flat, seed=12)


@pytest.mark.parametrize("mode", ["posterior", "sde"])
def test_latent_chain_through_dit_matches_jax(tiny_weights, compressor_weights, mode):
    """encode -> noisy = latent + max_sigma * z0 -> 10 reverse steps through
    the tiny DiT -> decode with the LQ skips -> crop, composed as
    make_latent_sampler does, with the same weights, z0 and noise_seq on
    both sides.  float32; bound 1e-4 of max|ref|: float32 rounding
    differences of the nets pass through 10 steps."""
    port, ref = IRSDE.create(**SDE_ARGS, device="cpu"), JIRSDE.create(**SDE_ARGS)
    r = np.random.default_rng(8)
    lq = r.random((2, 30, 26, 3), np.float32)
    lat_shape = (2, 16, 14, COMP["embed_dim"])  # 30x26 reflect-pads to 32x28, then /2
    z0 = r.standard_normal(lat_shape).astype(np.float32)
    noise_seq = r.standard_normal((STEPS, *lat_shape)).astype(np.float32)

    fc, fd = FlaxCompressor(**COMP), FlaxDiT(**TINY)
    cp, dp = unflatten(compressor_weights), unflatten(tiny_weights)
    jrev = {"posterior": jsamplers.reverse_posterior, "sde": jsamplers.reverse_sde}[mode]

    def jax_chain(img, z, ns):
        latent, hidden = fc.apply(cp, img, method=fc.encode)
        noisy = latent + ref.max_sigma * z
        out = jrev(ref, lambda x, m, t: fd.apply(dp, x, m, t), noisy, latent, steps=STEPS, noise_seq=ns)
        return fc.apply(cp, out, hidden, method=fc.decode)[:, : img.shape[1], : img.shape[2], :]

    want = np.asarray(jax.jit(jax_chain)(lq, z0, noise_seq))

    comp = UNet(**COMP)
    comp.load_state_dict(state_dict_from_flax(compressor_weights, keys=latent_unet_flax_keys(len(COMP["ch_mult"]))))
    comp.eval()
    net = port_dit(tiny_weights)
    prev = {"posterior": samplers.reverse_posterior, "sde": samplers.reverse_sde}[mode]
    with torch.inference_mode():
        latent, hidden = comp.encode(torch.from_numpy(lq))
        assert latent.shape == lat_shape
        noisy = latent + port.max_sigma * torch.from_numpy(z0)
        out = prev(port, net, noisy, latent, steps=STEPS, noise_seq=torch.from_numpy(noise_seq))
        got = comp.decode(out, hidden)[:, :30, :26, :].numpy()
    assert got.shape == lq.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------- registry
def test_registry_names_and_its_error():
    ladder = {f"DiT_{s}_{p}" for s in ("S", "B", "L", "XL") for p in (2, 4, 8)}
    nets = {"ConditionalUNet", "ConditionalNAFNet", "CNAFNetLocal", "StereoConditionalNAFNet", "BokehConditionalNAFNet",
            "UNet", "DiT"}
    assert set(available()) == nets | ladder
    net = build_network("DiT_S_4", {"in_channels": 8, "dtype": "bfloat16", "depth": 1})
    assert isinstance(net, DiT) and net.dtype == torch.bfloat16 and net.patch_size == 4
    assert net.blocks[0].attn.qkv.weight.shape == (3 * 384, 384) and len(net.blocks) == 1
    assert build_network("UNet", dict(COMP)).__class__ is UNet
    with pytest.raises(ValueError, match=r"unknown network 'DiT_M_2'; available: \['BokehConditionalNAFNet'"):
        build_network("DiT_M_2", {})
