"""Load flax ``ConditionalUNet`` parameters into the PyTorch module.

The reverse direction of ``image_restoration_sde_tpu/utils/torch_import.py``:
a flax parameter tree, flattened to ``{"a/b/kernel": array}`` (without the
leading ``params``), becomes a ``state_dict`` in the reference torch key
space, with each layout transform inverted:

- conv kernels HWIO -> OIHW,
- dense kernels (in, out) -> (out, in),
- norm gains (C,) -> (1, C, 1, 1).

The key map is this package's own copy; the tests hold it against
``unet_key_rules``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_INVERSE = {
    "conv": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "dense": lambda w: np.transpose(w, (1, 0)),
    "norm": lambda w: np.reshape(w, (1, -1, 1, 1)),
    "ident": np.asarray,
}

Entry = Tuple[str, str]  # (flax path, transform kind)


def _resblock(tp: str, fp: str, res_conv: bool) -> Dict[str, Entry]:
    keys = {
        f"{tp}.mlp.1.weight": (f"{fp}/Dense_0/kernel", "dense"),
        f"{tp}.mlp.1.bias": (f"{fp}/Dense_0/bias", "ident"),
        f"{tp}.block1.proj.weight": (f"{fp}/Block_0/Conv_0/kernel", "conv"),
        f"{tp}.block2.proj.weight": (f"{fp}/Block_1/Conv_0/kernel", "conv"),
    }
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


def unet_flax_keys(depth: int = 4) -> Dict[str, Entry]:
    """torch ``state_dict`` key -> (flax path, transform kind) for the
    conditional ``ConditionalUNet``."""
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
    keys.update(_linear_attn("mid_attn", "mid_attn", "mid_attn_wrap"))
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


def state_dict_from_flax(flat: Mapping[str, np.ndarray], depth: int) -> Dict[str, torch.Tensor]:
    """Flattened flax ``ConditionalUNet`` params -> torch ``state_dict``.

    Every flax leaf must be used exactly once: a leftover or missing path
    raises, as a strict ``load_state_dict`` would."""
    keys = unet_flax_keys(depth)
    missing = sorted({fp for fp, _ in keys.values()} - set(flat))
    unused = sorted(set(flat) - {fp for fp, _ in keys.values()})
    if missing or unused:
        raise ValueError(f"flax params do not match depth={depth}: missing {missing[:5]}, unused {unused[:5]}")
    return {
        tk: torch.from_numpy(np.ascontiguousarray(_INVERSE[kind](np.asarray(flat[fp], np.float32))))
        for tk, (fp, kind) in keys.items()
    }
