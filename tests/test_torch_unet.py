"""PyTorch port, score network: the weight bridge's key map against
``unet_key_rules`` and the ConditionalUNet forward against the flax module
with the same weights, float32 and bfloat16, in both variants (the
unconditional one, with full attention in its mid block, is the denoising
SDE's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from image_restoration_sde_tpu.models import ConditionalUNet as FlaxUNet
from image_restoration_sde_tpu.utils.torch_import import unet_key_rules
from image_restoration_sde_tpu_torch.models import ConditionalUNet
from image_restoration_sde_tpu_torch.utils import state_dict_from_flax, unet_flax_keys

TINY = dict(in_nc=3, out_nc=3, nf=8, depth=2)
# transform names in utils/torch_import.py for each kind the bridge inverts
KIND_OF = {"_conv_w": "conv", "_dense_w": "dense", "_norm_g": "norm", "_ident": "ident"}


def flatten(params) -> dict:
    flat, _ = tree_flatten_with_path(params)
    return {"/".join(str(k.key) for k in path[1:]): np.asarray(leaf) for path, leaf in flat}


def random_flax_params(depth: int, nf: int, seed: int = 0, conditional: bool = True) -> dict:
    """Flax-initialised tree with every leaf replaced by seeded numpy values
    (kernels ~ 1/sqrt(fan_in), biases and gains off their defaults), so
    every parameter shows in the output."""
    net = FlaxUNet(in_nc=3, out_nc=3, nf=nf, depth=depth, conditional=conditional)
    x = jnp.zeros((1, 16, 16, 3))
    flat = flatten(jax.jit(net.init)(jax.random.PRNGKey(0), x, x if conditional else None, jnp.array([1.0])))
    r = np.random.default_rng(seed)
    out = {}
    for path, leaf in flat.items():
        if path.endswith("/g"):
            v = 1 + 0.2 * r.standard_normal(leaf.shape)
        elif path.endswith("bias"):
            v = 0.1 * r.standard_normal(leaf.shape)
        else:
            v = r.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        out[path] = v.astype(np.float32)
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return {"params": tree}


@pytest.fixture(scope="module")
def tiny_weights():
    return random_flax_params(TINY["depth"], TINY["nf"])


@pytest.mark.parametrize("conditional", [True, False])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_key_map_matches_unet_key_rules(depth, conditional):
    rules = unet_key_rules(depth, conditional=conditional)
    keys = unet_flax_keys(depth, conditional=conditional)
    assert {fp for fp, _ in keys.values()} == set(rules) and len(keys) == len(rules)
    for tkey, (fpath, kind) in keys.items():
        r_tkey, r_tf = rules[fpath]
        assert r_tkey == tkey, fpath
        assert KIND_OF[r_tf.__name__] == kind, fpath
    net = ConditionalUNet(in_nc=3, out_nc=3, nf=8, depth=depth, conditional=conditional)
    assert set(keys) == set(net.state_dict())


def test_bridge_fills_every_key_once_with_its_shape(tiny_weights):
    assert len(tiny_weights) == 87
    sd = state_dict_from_flax(tiny_weights, TINY["depth"])
    net = ConditionalUNet(**TINY)
    want = net.state_dict()
    assert set(sd) == set(want) and len(sd) == len(tiny_weights)
    for k, v in sd.items():
        assert v.shape == want[k].shape and v.dtype == torch.float32, k
    net.load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="unused"):
        state_dict_from_flax({**tiny_weights, "extra/kernel": np.zeros(1)}, TINY["depth"])


def test_param_count_matches_reference_golden():
    # tests/test_models.py GOLD_SMALL: the reference torch ConditionalUNet(nf=16, depth=3)
    net = ConditionalUNet(in_nc=3, out_nc=3, nf=16, depth=3)
    assert sum(p.numel() for p in net.parameters()) == 2_406_691


def _forward_pair(weights, dtype, hw, seed=0):
    r = np.random.default_rng(seed)
    xt = r.random((2, *hw, 3), np.float32)
    cond = r.random((2, *hw, 3), np.float32)
    tvec = np.array([7, 93], np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    fnet = FlaxUNet(**TINY, dtype=jdt)
    want = np.asarray(jax.jit(fnet.apply)(unflatten(weights), xt, cond, tvec))
    net = ConditionalUNet(**TINY, dtype=tdt)
    net.load_state_dict(state_dict_from_flax(weights, TINY["depth"]))
    with torch.inference_mode():
        got = net(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(tvec))
    assert got.shape == (2, *hw, 3) and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("hw", [(32, 32), (30, 20)], ids=str)
def test_forward_matches_flax_f32(tiny_weights, hw):
    """Bound 1e-4 of max|out|: float32 convolutions and matmuls (flax at
    'highest' precision) sum in another order through ~30 layers."""
    got, want = _forward_pair(tiny_weights, "float32", hw)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("hw", [(32, 32), (30, 20)], ids=str)
def test_forward_matches_flax_bf16(tiny_weights, hw):
    """Bound 5e-2 of max|out|: both nets compute in bfloat16 with float32
    parameters, but round at different places (flax's CPU linear attention
    feeds bf16 operands to its contractions, the port computes it in
    float32; convolutions accumulate differently), and bf16 keeps 8
    significant bits, so each layer adds ~0.4% and the differences compound
    through ~30 layers.  The float32 forward of the same weights is the
    yardstick: the port's bf16 output must also stay as close to it as
    flax's bf16 output does, within a factor of 2."""
    got, want = _forward_pair(tiny_weights, "bfloat16", hw)
    f32, _ = _forward_pair(tiny_weights, "float32", hw)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-2 * scale
    assert np.abs(got - f32).max() <= 2 * np.abs(want - f32).max()


# ------------------------------------------------ unconditional variant
@pytest.fixture(scope="module")
def uncond_weights():
    return random_flax_params(TINY["depth"], TINY["nf"], seed=1, conditional=False)


def uncond_port(weights, dtype=torch.float32) -> ConditionalUNet:
    net = ConditionalUNet(**TINY, conditional=False, dtype=dtype)
    net.load_state_dict(state_dict_from_flax(weights, keys=unet_flax_keys(TINY["depth"], conditional=False)))
    return net.eval()


def _uncond_pair(weights, dtype, hw):
    r = np.random.default_rng(3)
    x = r.random((2, *hw, 3), np.float32)
    tvec = np.array([40, 3], np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    fnet = FlaxUNet(**TINY, conditional=False, dtype=jdt)
    want = np.asarray(jax.jit(lambda p, a, t: fnet.apply(p, a, None, t))(unflatten(weights), x, tvec))
    with torch.inference_mode():
        got = uncond_port(weights, tdt)(torch.from_numpy(x), None, torch.from_numpy(tvec))
    assert got.shape == (2, *hw, 3) and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("hw", [(32, 32), (30, 20)], ids=str)
def test_unconditional_forward_matches_flax(uncond_weights, hw):
    """No LQ concat (init_conv takes in_nc), full attention in the mid
    block.  float32: 1e-4 of max|out|, as the conditional net's; bfloat16:
    that net's bounds (5e-2 of max|out|, and within twice flax's own
    bf16-vs-f32 distance of the f32 forward)."""
    got, want = _uncond_pair(uncond_weights, "float32", hw)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    got16, want16 = _uncond_pair(uncond_weights, "bfloat16", hw)
    assert np.abs(got16 - want16).max() <= 5e-2 * np.abs(want16).max()
    assert np.abs(got16 - got).max() <= 2 * np.abs(want16 - got).max()
