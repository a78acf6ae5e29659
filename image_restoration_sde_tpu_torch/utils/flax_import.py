"""Load flax parameters into the PyTorch modules: ``ConditionalUNet`` (both
variants), ``ConditionalNAFNet``, ``StereoConditionalNAFNet``,
``BokehConditionalNAFNet``, the latent compressor ``UNet`` and ``DiT``.

The reverse direction of ``image_restoration_sde_tpu/utils/torch_import.py``:
a flax parameter tree, flattened to ``{"a/b/kernel": array}`` (without the
leading ``params``), becomes a ``state_dict`` in the reference torch key
space, with each layout transform inverted:

- conv kernels HWIO -> OIHW,
- dense kernels (in, out) -> (out, in),
- norm gains and NAFBlock beta/gamma (C,) -> (1, C, 1, 1);
  depthwise kernels (3, 3, 1, D) take the conv transform to (D, 1, 3, 3).

The key maps are this package's own copies; the tests hold them against
``unet_key_rules``, ``nafnet_key_rules``, ``stereo_nafnet_key_rules``,
``bokeh_nafnet_key_rules``, ``latent_unet_key_rules`` and ``dit_key_rules``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_INVERSE = {
    "conv": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "dense": lambda w: np.transpose(w, (1, 0)),
    "norm": lambda w: np.reshape(w, (1, -1, 1, 1)),
    "ident": np.asarray,
}

Entry = Tuple[str, str]  # (flax path, transform kind)


def _resblock(tp: str, fp: str, res_conv: bool, mlp: bool = True) -> Dict[str, Entry]:
    keys = {
        f"{tp}.block1.proj.weight": (f"{fp}/Block_0/Conv_0/kernel", "conv"),
        f"{tp}.block2.proj.weight": (f"{fp}/Block_1/Conv_0/kernel", "conv"),
    }
    if mlp:
        keys[f"{tp}.mlp.1.weight"] = (f"{fp}/Dense_0/kernel", "dense")
        keys[f"{tp}.mlp.1.bias"] = (f"{fp}/Dense_0/bias", "ident")
    if res_conv:
        keys[f"{tp}.res_conv.weight"] = (f"{fp}/Conv_0/kernel", "conv")
    return keys


def _linear_attn(tp: str, fp_attn: str, fp_wrap: str) -> Dict[str, Entry]:
    return {
        f"{tp}.fn.norm.g": (f"{fp_wrap}/ChannelLayerNorm_0/g", "norm"),
        f"{tp}.fn.fn.to_qkv.weight": (f"{fp_attn}/Conv_0/kernel", "conv"),
        f"{tp}.fn.fn.to_out.0.weight": (f"{fp_attn}/Conv_1/kernel", "conv"),
        f"{tp}.fn.fn.to_out.0.bias": (f"{fp_attn}/Conv_1/bias", "ident"),
        f"{tp}.fn.fn.to_out.1.g": (f"{fp_attn}/ChannelLayerNorm_0/g", "norm"),
    }


def _full_attn(tp: str, fp_attn: str, fp_wrap: str) -> Dict[str, Entry]:
    return {
        f"{tp}.fn.norm.g": (f"{fp_wrap}/ChannelLayerNorm_0/g", "norm"),
        f"{tp}.fn.fn.to_qkv.weight": (f"{fp_attn}/Conv_0/kernel", "conv"),
        f"{tp}.fn.fn.to_out.weight": (f"{fp_attn}/Conv_1/kernel", "conv"),
        f"{tp}.fn.fn.to_out.bias": (f"{fp_attn}/Conv_1/bias", "ident"),
    }


def unet_flax_keys(depth: int = 4, conditional: bool = True) -> Dict[str, Entry]:
    """torch ``state_dict`` key -> (flax path, transform kind) for
    ``ConditionalUNet``; the unconditional variant's mid block is full
    attention."""
    keys: Dict[str, Entry] = {
        "init_conv.weight": ("init_conv/kernel", "conv"),
        "time_mlp.1.weight": ("time_mlp_1/kernel", "dense"),
        "time_mlp.1.bias": ("time_mlp_1/bias", "ident"),
        "time_mlp.3.weight": ("time_mlp_2/kernel", "dense"),
        "time_mlp.3.bias": ("time_mlp_2/bias", "ident"),
        "final_conv.weight": ("final_conv/kernel", "conv"),
        "final_conv.bias": ("final_conv/bias", "ident"),
    }
    keys.update(_resblock("final_res_block", "final_res_block", True))
    keys.update(_resblock("mid_block1", "mid_block1", False))
    keys.update(_resblock("mid_block2", "mid_block2", False))
    mid_attn = _linear_attn if conditional else _full_attn
    keys.update(mid_attn("mid_attn", "mid_attn", "mid_attn_wrap"))
    for i in range(depth):
        keys.update(_resblock(f"downs.{i}.0", f"down{i}_block1", False))
        keys.update(_resblock(f"downs.{i}.1", f"down{i}_block2", False))
        keys.update(_linear_attn(f"downs.{i}.2", f"down{i}_attn", f"down{i}_attn_wrap"))
        if i != depth - 1:
            keys[f"downs.{i}.3.weight"] = (f"down{i}_down/Conv_0/kernel", "conv")
            keys[f"downs.{i}.3.bias"] = (f"down{i}_down/Conv_0/bias", "ident")
        else:
            keys[f"downs.{i}.3.weight"] = (f"down{i}_down/kernel", "conv")

        j = depth - 1 - i  # ups[j] is level i
        keys.update(_resblock(f"ups.{j}.0", f"up{i}_block1", True))
        keys.update(_resblock(f"ups.{j}.1", f"up{i}_block2", True))
        keys.update(_linear_attn(f"ups.{j}.2", f"up{i}_attn", f"up{i}_attn_wrap"))
        if i != 0:
            keys[f"ups.{j}.3.1.weight"] = (f"up{i}_up/Conv_0/kernel", "conv")
            keys[f"ups.{j}.3.1.bias"] = (f"up{i}_up/Conv_0/bias", "ident")
        else:
            keys[f"ups.{j}.3.weight"] = (f"up{i}_up/kernel", "conv")
    return keys


def _conv_bias(keys: Dict[str, Entry], tp: str, fp: str, bias: bool = True) -> None:
    keys[f"{tp}.weight"] = (f"{fp}/kernel", "conv")
    if bias:
        keys[f"{tp}.bias"] = (f"{fp}/bias", "ident")


def _naf_block(tp: str, fp: str) -> Dict[str, Entry]:
    keys: Dict[str, Entry] = {
        f"{tp}.beta": (f"{fp}/beta", "norm"),
        f"{tp}.gamma": (f"{fp}/gamma", "norm"),
        f"{tp}.norm1.g": (f"{fp}/norm1/g", "norm"),
        f"{tp}.norm2.g": (f"{fp}/norm2/g", "norm"),
        f"{tp}.mlp.1.weight": (f"{fp}/Dense_0/kernel", "dense"),
        f"{tp}.mlp.1.bias": (f"{fp}/Dense_0/bias", "ident"),
    }
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        _conv_bias(keys, f"{tp}.{name}", f"{fp}/{name}")
    _conv_bias(keys, f"{tp}.sca.1", f"{fp}/sca_conv")
    return keys


def _naf_levels(keys: Dict[str, Entry], block, enc_blk_nums: Sequence[int], middle_blk_num: int,
                dec_blk_nums: Sequence[int]) -> Dict[str, Entry]:
    """The NAFNet skeleton shared by the three variants: ``block(tp, fp)``
    maps one block."""
    _conv_bias(keys, "intro", "intro")
    _conv_bias(keys, "ending", "ending")
    for i, num in enumerate(enc_blk_nums):
        for b in range(num):
            keys.update(block(f"encoders.{i}.{b}", f"enc{i}_block{b}"))
        _conv_bias(keys, f"downs.{i}", f"down{i}")
    for b in range(middle_blk_num):
        keys.update(block(f"middle_blks.{b}", f"mid_block{b}"))
    for i, num in enumerate(dec_blk_nums):
        _conv_bias(keys, f"ups.{i}.0", f"up{i}", bias=False)
        for b in range(num):
            keys.update(block(f"decoders.{i}.{b}", f"dec{i}_block{b}"))
    return keys


def _naf_time_mlp() -> Dict[str, Entry]:
    return {
        "time_mlp.1.weight": ("time_mlp_1/kernel", "dense"),
        "time_mlp.1.bias": ("time_mlp_1/bias", "ident"),
        "time_mlp.3.weight": ("time_mlp_2/kernel", "dense"),
        "time_mlp.3.bias": ("time_mlp_2/bias", "ident"),
    }


def nafnet_flax_keys(enc_blk_nums: Sequence[int], middle_blk_num: int,
                     dec_blk_nums: Sequence[int]) -> Dict[str, Entry]:
    """torch ``state_dict`` key -> (flax path, transform kind) for
    ``ConditionalNAFNet``."""
    return _naf_levels(_naf_time_mlp(), _naf_block, enc_blk_nums, middle_blk_num, dec_blk_nums)


def _scam(tp: str, fp: str) -> Dict[str, Entry]:
    keys: Dict[str, Entry] = {
        f"{tp}.norm_l.g": (f"{fp}/norm_l/g", "norm"),
        f"{tp}.norm_r.g": (f"{fp}/norm_r/g", "norm"),
        f"{tp}.beta": (f"{fp}/beta", "norm"),
        f"{tp}.gamma": (f"{fp}/gamma", "norm"),
    }
    for proj in ("l_proj1", "r_proj1", "l_proj2", "r_proj2"):
        _conv_bias(keys, f"{tp}.{proj}", f"{fp}/{proj}")
    return keys


def stereo_nafnet_flax_keys(enc_blk_nums: Sequence[int], middle_blk_num: int,
                            dec_blk_nums: Sequence[int]) -> Dict[str, Entry]:
    """torch ``state_dict`` key -> (flax path, transform kind) for
    ``StereoConditionalNAFNet``: each torch block carries its SCAM as
    ``.fusion``; flax nests the two as ``block`` and ``fusion``."""

    def block(tp, fp):
        return {**_naf_block(tp, f"{fp}/block"), **_scam(f"{tp}.fusion", f"{fp}/fusion")}

    return _naf_levels(_naf_time_mlp(), block, enc_blk_nums, middle_blk_num, dec_blk_nums)


def bokeh_nafnet_flax_keys(enc_blk_nums: Sequence[int], middle_blk_num: int,
                           dec_blk_nums: Sequence[int]) -> Dict[str, Entry]:
    """torch ``state_dict`` key -> (flax path, transform kind) for
    ``BokehConditionalNAFNet``: the net's time and camera MLPs are
    Sequential(Linear, SimpleGate, Linear) (indices 0 and 2), each block's
    ``time_mlp`` and ``cam_mlp`` Sequential(SimpleGate, Linear)."""

    def block(tp, fp):
        keys = {k: e for k, e in _naf_block(tp, fp).items() if ".mlp." not in k}
        for name in ("time_mlp", "cam_mlp"):
            keys[f"{tp}.{name}.1.weight"] = (f"{fp}/{name}/kernel", "dense")
            keys[f"{tp}.{name}.1.bias"] = (f"{fp}/{name}/bias", "ident")
        return keys

    keys: Dict[str, Entry] = {}
    for name in ("time_mlp", "cam_mlp"):
        _dense(keys, f"{name}.0", f"{name}_1")
        _dense(keys, f"{name}.2", f"{name}_2")
    return _naf_levels(keys, block, enc_blk_nums, middle_blk_num, dec_blk_nums)


def latent_unet_flax_keys(depth: int = 4) -> Dict[str, Entry]:
    """torch ``state_dict`` key -> (flax path, transform kind) for the
    latent compressor ``UNet``; torch ``decoder.{k}`` is level depth-1-k."""
    keys: Dict[str, Entry] = {
        "init_conv.weight": ("init_conv/kernel", "conv"),
        "latent_conv.weight": ("latent_conv/kernel", "conv"),
        "post_latent_conv.weight": ("post_latent_conv/kernel", "conv"),
    }
    _conv_bias(keys, "final_conv", "final_conv")
    for i in range(depth):
        last = i == depth - 1
        k = depth - 1 - i
        keys.update(_resblock(f"encoder.{i}.0", f"enc{i}_block1", False, mlp=False))
        keys.update(_resblock(f"encoder.{i}.1", f"enc{i}_block2", False, mlp=False))
        keys.update(_resblock(f"decoder.{k}.0", f"dec{i}_block1", True, mlp=False))
        keys.update(_resblock(f"decoder.{k}.1", f"dec{i}_block2", True, mlp=False))
        if last:
            keys.update(_linear_attn(f"encoder.{i}.2", f"enc{i}_attn", f"enc{i}_attn_wrap"))
            keys.update(_linear_attn(f"decoder.{k}.2", f"dec{i}_attn", f"dec{i}_attn_wrap"))
            _conv_bias(keys, f"encoder.{i}.3", f"enc{i}_down", bias=False)
        else:
            _conv_bias(keys, f"encoder.{i}.3", f"enc{i}_down/Conv_0")
        if i == 0:
            _conv_bias(keys, f"decoder.{k}.3", f"dec{i}_up", bias=False)
        else:
            _conv_bias(keys, f"decoder.{k}.3.1", f"dec{i}_up/Conv_0")
    return keys


def _dense(keys: Dict[str, Entry], tp: str, fp: str) -> None:
    keys[f"{tp}.weight"] = (f"{fp}/kernel", "dense")
    keys[f"{tp}.bias"] = (f"{fp}/bias", "ident")


def dit_flax_keys(depth: int = 28) -> Dict[str, Entry]:
    """torch ``state_dict`` key -> (flax path, transform kind) for ``DiT``;
    its LayerNorms have no parameters on either side."""
    keys: Dict[str, Entry] = {}
    _conv_bias(keys, "patch_embed.proj", "patch_embed")
    _dense(keys, "t_embedder.mlp.0", "t_mlp_1")
    _dense(keys, "t_embedder.mlp.2", "t_mlp_2")
    _dense(keys, "final_layer.adaLN_modulation.1", "final_adaLN")
    _dense(keys, "final_layer.linear", "final_linear")
    for i in range(depth):
        tp, fp = f"blocks.{i}", f"block{i}"
        _dense(keys, f"{tp}.adaLN_modulation.1", f"{fp}/adaLN")
        _dense(keys, f"{tp}.attn.qkv", f"{fp}/MHA_0/qkv")
        _dense(keys, f"{tp}.attn.proj", f"{fp}/MHA_0/proj")
        _dense(keys, f"{tp}.mlp.fc1", f"{fp}/Dense_0")
        _dense(keys, f"{tp}.mlp.fc2", f"{fp}/Dense_1")
    return keys


def state_dict_from_flax(
    flat: Mapping[str, np.ndarray], depth: int = 4, keys: Optional[Mapping[str, Entry]] = None
) -> Dict[str, torch.Tensor]:
    """Flattened flax params -> torch ``state_dict``, through ``keys`` (a
    key map of this module; default: ``unet_flax_keys(depth)``).

    Every flax leaf must be used exactly once: a leftover or missing path
    raises, as a strict ``load_state_dict`` would."""
    if keys is None:
        keys = unet_flax_keys(depth)
    missing = sorted({fp for fp, _ in keys.values()} - set(flat))
    unused = sorted(set(flat) - {fp for fp, _ in keys.values()})
    if missing or unused:
        raise ValueError(f"flax params do not match the key map: missing {missing[:5]}, unused {unused[:5]}")
    return {
        tk: torch.from_numpy(np.ascontiguousarray(_INVERSE[kind](np.asarray(flat[fp], np.float32))))
        for tk, (fp, kind) in keys.items()
    }
