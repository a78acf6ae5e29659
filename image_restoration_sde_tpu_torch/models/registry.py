"""Network factory: a YAML ``which_model`` name and its ``setting`` kwargs ->
``nn.Module``.

Counterpart of ``image_restoration_sde_tpu/models/registry.py`` for the
networks the port has.  A ``dtype`` given as a string ("bfloat16"), as a
YAML setting gives it, becomes the torch dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import dit
from .bokeh_nafnet import BokehConditionalNAFNet
from .latent_unet import UNet
from .nafnet import ConditionalNAFNet
from .stereo_nafnet import StereoConditionalNAFNet
from .unet import ConditionalUNet



def cnafnet_local(train_size=(1, 3, 128, 128), fast_imp: bool = False, **setting) -> ConditionalNAFNet:
    """The reference's ``CNAFNetLocal``: ConditionalNAFNet with TLSC windows
    pinned to the train crop, ``train_size``'s last two entries.
    ``fast_imp`` selects the reference's other code for the same windowed
    mean; it is ignored, as in the JAX package."""
    return ConditionalNAFNet(tlsc_train_size=(int(train_size[-2]), int(train_size[-1])), **setting)


_REGISTRY: Dict[str, Any] = {
    "ConditionalUNet": ConditionalUNet,
    "ConditionalNAFNet": ConditionalNAFNet,
    "CNAFNetLocal": cnafnet_local,
    "StereoConditionalNAFNet": StereoConditionalNAFNet,
    "BokehConditionalNAFNet": BokehConditionalNAFNet,
    "UNet": UNet,
    "DiT": dit.DiT,
    **dit.LADDER,
}


def available() -> list:
    return sorted(_REGISTRY)


def build_network(which_model: str, setting: Optional[Dict[str, Any]] = None, **overrides):
    """Instantiate a registered network by its reference class name."""
    setting = {**(setting or {}), **overrides}
    if isinstance(setting.get("dtype"), str):
        setting["dtype"] = getattr(torch, setting["dtype"])
    try:
        cls = _REGISTRY[which_model]
    except KeyError:
        raise ValueError(f"unknown network {which_model!r}; available: {available()}") from None
    return cls(**setting)
