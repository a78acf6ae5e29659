"""LPIPS v0.1 perceptual distance (alex and vgg backbones) as an ``nn.Module``.

Counterpart of ``image_restoration_sde_tpu/utils/lpips.py``, with its own
copy of the layer tables.  The math of ``lpips.LPIPS(net=...)`` with
``spatial=False``: the inputs scaled by the lpips scaling layer, the
backbone's features taken after the last ReLU of each slice, each tap
divided by its norm over the channels, the squared differences weighted by
the learned 1x1 linear heads (no bias), averaged over the map and summed
over the taps.  The convolutions run through torch (cuDNN on the card), as
the JAX package leaves them to XLA.

Weights come from a full ``lpips.LPIPS(net=...).state_dict()`` saved as a
``.pth`` (or an ``.npz`` with the same keys): it holds the torchvision
backbone (``net.slice*``) and the linear heads (``lin*.model.1.weight``);
the backbone is detected from the keys.  The official v0.1 ``.pth`` holds
only the heads and is refused.  Nothing is downloaded, and the ``lpips``
pip package is not used.

    torch.save(lpips.LPIPS(net="alex").state_dict(), "lpips_alex.pth")

``make_lpips_fn`` is the test entry point's metric (``--lpips-pth`` or
``IRSDE_LPIPS_PTH``); ``make_perceptual_loss_fn`` gives
``training.losses.perceptual_matching_loss`` a differentiable ``lpips_fn``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Backbone convs: (kernel, stride, pad, out_ch, state-dict prefix, max-pool
# before this conv).  The lpips wrapper names each slice's layers by their
# index in torchvision's ``features`` (net.slice2.3 = features[3]).
ALEX_CONVS = (
    (11, 4, 2, 64, "net.slice1.0", False),
    (5, 1, 2, 192, "net.slice2.3", True),
    (3, 1, 1, 384, "net.slice3.6", True),
    (3, 1, 1, 256, "net.slice4.8", False),
    (3, 1, 1, 256, "net.slice5.10", False),
)
# VGG16 features, tapped at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3
# (a 2x2 stride-2 max-pool opens slices 2-5)
VGG_CONVS = (
    (3, 1, 1, 64, "net.slice1.0", False),
    (3, 1, 1, 64, "net.slice1.2", False),
    (3, 1, 1, 128, "net.slice2.5", True),
    (3, 1, 1, 128, "net.slice2.7", False),
    (3, 1, 1, 256, "net.slice3.10", True),
    (3, 1, 1, 256, "net.slice3.12", False),
    (3, 1, 1, 256, "net.slice3.14", False),
    (3, 1, 1, 512, "net.slice4.17", True),
    (3, 1, 1, 512, "net.slice4.19", False),
    (3, 1, 1, 512, "net.slice4.21", False),
    (3, 1, 1, 512, "net.slice5.24", True),
    (3, 1, 1, 512, "net.slice5.26", False),
    (3, 1, 1, 512, "net.slice5.28", False),
)
# taps: the convs whose ReLU output feeds linear head k; pool: the
# backbone's max-pool (kernel, stride)
SPECS = {
    "alex": {"convs": ALEX_CONVS, "taps": (0, 1, 2, 3, 4), "pool": (3, 2)},
    "vgg": {"convs": VGG_CONVS, "taps": (1, 3, 6, 9, 12), "pool": (2, 2)},
}
# lpips's ScalingLayer constants
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def detect_net(keys) -> str:
    """'vgg' iff the state dict has VGG's second slice-1 conv."""
    return "vgg" if "net.slice1.2.weight" in keys else "alex"


class LPIPS(nn.Module):
    """LPIPS v0.1 of ``net`` ("alex" or "vgg"); ``forward(img0, img1)``
    takes NHWC float32 in [-1, 1] and returns the (B,) distances.  Its
    ``state_dict`` keys are lpips's."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        self.net_name = net
        spec = SPECS[net]
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1))
        self.convs = nn.ModuleList()
        in_ch = 3
        for k, s, p, out_ch, _, _ in spec["convs"]:
            self.convs.append(nn.Conv2d(in_ch, out_ch, k, s, p))
            in_ch = out_ch
        self.lins = nn.ModuleList(
            nn.Conv2d(spec["convs"][i][3], 1, 1, bias=False) for i in spec["taps"])

    def key_map(self) -> Dict[str, str]:
        """This module's state-dict key -> lpips's."""
        spec = SPECS[self.net_name]
        keys = {"shift": "scaling_layer.shift", "scale": "scaling_layer.scale"}
        for i, c in enumerate(spec["convs"]):
            keys[f"convs.{i}.weight"], keys[f"convs.{i}.bias"] = c[4] + ".weight", c[4] + ".bias"
        for k in range(len(spec["taps"])):
            keys[f"lins.{k}.weight"] = f"lin{k}.model.1.weight"
        return keys

    def features(self, x: torch.Tensor) -> list:
        """The unit-normalised taps of NCHW ``x`` in [-1, 1]."""
        spec = SPECS[self.net_name]
        pk, ps = spec["pool"]
        h = (x - self.shift) / self.scale
        taps = []
        for i, conv in enumerate(self.convs):
            if spec["convs"][i][5]:
                h = F.max_pool2d(h, pk, ps)
            h = F.relu(conv(h))
            if i in spec["taps"]:
                taps.append(h / (h.square().sum(dim=1, keepdim=True).sqrt() + 1e-10))
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        x = torch.cat([img0, img1]).permute(0, 3, 1, 2)  # one backbone pass for both
        total = 0.0
        for lin, f in zip(self.lins, self.features(x)):
            f0, f1 = f.chunk(2)
            total = total + lin((f0 - f1).square()).mean(dim=(1, 2, 3))
        return total


def from_state_dict(state_dict: Dict[str, np.ndarray], net: Optional[str] = None) -> LPIPS:
    """An ``LPIPS`` holding a full ``lpips.LPIPS(net=...).state_dict()``
    (tensors or numpy arrays); the backbone is detected from the keys
    unless ``net`` is given.  A state dict without the backbone (the
    official v0.1 ``.pth`` holds only the linear heads) is refused."""
    net = net or detect_net(state_dict)
    module = LPIPS(net)
    keys = module.key_map()
    missing = [k for k in keys.values() if k not in state_dict]
    if missing:
        raise ValueError(f"LPIPS state dict is missing the {net} keys {missing[:2]}...; the official v0.1 .pth "
                         f"ships only the linear heads. Save the FULL module instead: "
                         f"torch.save(lpips.LPIPS(net='{net}').state_dict(), ...)")
    own = module.state_dict()
    module.load_state_dict({k: torch.as_tensor(np.asarray(state_dict[src])).reshape(own[k].shape)
                            for k, src in keys.items()})
    return module.eval()


def read_state_dict(path: str) -> dict:
    """A state dict from a torch ``.pth`` or an ``.npz`` with the same keys."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return dict(z)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_lpips(path: str, device="cuda") -> LPIPS:
    """The LPIPS module of the weights at ``path``, on ``device``."""
    return from_state_dict(read_state_dict(path)).to(device)


def lpips_distance(module: LPIPS, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """(B,) LPIPS distances of NHWC inputs in [-1, 1]."""
    return module(img0, img1)


def make_perceptual_loss_fn(path: str, device="cuda") -> Callable:
    """``fn(predict, target) -> scalar``, the batch mean of LPIPS on NHWC
    inputs in [0, 1] (mapped to [-1, 1], as the reference's vgg lpips with
    ``normalize=True``), differentiable in both inputs; the weights take no
    gradient.  For ``training.losses.perceptual_matching_loss``."""
    module = load_lpips(path, device).requires_grad_(False)

    def fn(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return module(predict * 2.0 - 1.0, target * 2.0 - 1.0).mean()

    return fn


def make_lpips_fn(path: str, device="cuda") -> Callable:
    """The test entry point's metric: ``fn(a, b) -> float`` on two uint8 RGB
    HWC images, mapped to [-1, 1] as the reference does (``x / 127.5 - 1``)."""
    module = load_lpips(path, device)

    @torch.inference_mode()
    def compute(a: np.ndarray, b: np.ndarray) -> float:
        x = torch.from_numpy(np.stack([a, b])).to(device).float() / 127.5 - 1.0
        return float(module(x[:1], x[1:])[0])

    return compute


def lpips_fn_from_env_or_arg(path: Optional[str], device="cuda") -> Optional[Callable]:
    """``--lpips-pth`` if given, else ``IRSDE_LPIPS_PTH``; None when neither
    is set."""
    path = path or os.environ.get("IRSDE_LPIPS_PTH")
    return make_lpips_fn(path, device) if path else None


def seeded_state_dict(net: str = "alex", seed: int = 0) -> Dict[str, torch.Tensor]:
    """A full lpips state dict of ``net`` with random weights from ``seed``
    (convs ~ 1/sqrt(fan_in), heads uniform in [0, 0.1), non-negative as
    lpips's are): for runs and tests where the published weights are not
    at hand."""
    gen = torch.Generator().manual_seed(seed)
    module = LPIPS(net)
    own = {}
    for k, v in module.state_dict().items():
        if k in ("shift", "scale"):
            own[k] = v
        elif k.startswith("lins."):
            own[k] = torch.rand(v.shape, generator=gen) * 0.1
        else:
            fan_in = v[0].numel() if v.dim() > 1 else 1
            own[k] = torch.randn(v.shape, generator=gen) / (fan_in ** 0.5 if v.dim() > 1 else 20.0)
    return {module.key_map()[k]: v for k, v in own.items()}
