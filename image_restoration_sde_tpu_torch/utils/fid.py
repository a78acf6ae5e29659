"""FID (Fréchet Inception Distance) with an InceptionV3 ``nn.Module``.

Counterpart of ``image_restoration_sde_tpu/utils/fid.py``, with its own copy
of the layer table.  The network is the ``pytorch-fid`` InceptionV3 (the one
published FID numbers use) up to its 2048-d pool3 features: its in-block
3x3 average pools leave the padding out of the count, and Mixed_7c pools
its branch_pool input with a max pool.  Each BasicConv2d's BatchNorm (eps
1e-3, inference) is folded into its convolution when the weights load.
The convolutions run through torch (cuDNN on the card).

Inputs are NHWC float in [0, 1]; each image is resized to 299x299 on its
own (bilinear, half-pixel centres, antialiased when it shrinks: the JAX
package's ``jax.image.resize``), scaled to [-1, 1], and the features of a
batch of images are taken in one forward.  The JAX package runs one image
per call; the statistics are the same up to float sums in another order.

Weights come from a ``.pth`` (or ``.npz``) state dict with pytorch-fid or
torchvision names (fc and AuxLogits keys are ignored); nothing is
downloaded:

    from pytorch_fid.inception import fid_inception_v3
    torch.save(fid_inception_v3().state_dict(), "fid_inception.pth")

``FIDMetric`` is the test entry point's set-level metric (``--fid-pth`` or
``IRSDE_FID_PTH``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .lpips import read_state_dict

BN_EPS = 1e-3
SIZE = 299  # the network's input side
FEATURES = 2048


def _a(in_ch: int, pool_features: int) -> dict:
    return {"branch1x1": (64, in_ch, 1, 1), "branch5x5_1": (48, in_ch, 1, 1), "branch5x5_2": (64, 48, 5, 5),
            "branch3x3dbl_1": (64, in_ch, 1, 1), "branch3x3dbl_2": (96, 64, 3, 3), "branch3x3dbl_3": (96, 96, 3, 3),
            "branch_pool": (pool_features, in_ch, 1, 1)}


def _b(in_ch: int) -> dict:
    return {"branch3x3": (384, in_ch, 3, 3), "branch3x3dbl_1": (64, in_ch, 1, 1), "branch3x3dbl_2": (96, 64, 3, 3),
            "branch3x3dbl_3": (96, 96, 3, 3)}


def _c(in_ch: int, c7: int) -> dict:
    return {"branch1x1": (192, in_ch, 1, 1), "branch7x7_1": (c7, in_ch, 1, 1), "branch7x7_2": (c7, c7, 1, 7),
            "branch7x7_3": (192, c7, 7, 1), "branch7x7dbl_1": (c7, in_ch, 1, 1), "branch7x7dbl_2": (c7, c7, 7, 1),
            "branch7x7dbl_3": (c7, c7, 1, 7), "branch7x7dbl_4": (c7, c7, 7, 1), "branch7x7dbl_5": (192, c7, 1, 7),
            "branch_pool": (192, in_ch, 1, 1)}


def _d(in_ch: int) -> dict:
    return {"branch3x3_1": (192, in_ch, 1, 1), "branch3x3_2": (320, 192, 3, 3), "branch7x7x3_1": (192, in_ch, 1, 1),
            "branch7x7x3_2": (192, 192, 1, 7), "branch7x7x3_3": (192, 192, 7, 1), "branch7x7x3_4": (192, 192, 3, 3)}


def _e(in_ch: int) -> dict:
    return {"branch1x1": (320, in_ch, 1, 1), "branch3x3_1": (384, in_ch, 1, 1), "branch3x3_2a": (384, 384, 1, 3),
            "branch3x3_2b": (384, 384, 3, 1), "branch3x3dbl_1": (448, in_ch, 1, 1), "branch3x3dbl_2": (384, 448, 3, 3),
            "branch3x3dbl_3a": (384, 384, 1, 3), "branch3x3dbl_3b": (384, 384, 3, 1),
            "branch_pool": (192, in_ch, 1, 1)}


def layer_shapes() -> Dict[str, Tuple[int, int, int, int]]:
    """Every BasicConv2d of the pool3 extractor, by its state-dict name
    (pytorch-fid and torchvision), with its OIHW weight shape."""
    shapes = {"Conv2d_1a_3x3": (32, 3, 3, 3), "Conv2d_2a_3x3": (32, 32, 3, 3), "Conv2d_2b_3x3": (64, 32, 3, 3),
              "Conv2d_3b_1x1": (80, 64, 1, 1), "Conv2d_4a_3x3": (192, 80, 3, 3)}
    blocks = [("Mixed_5b", _a(192, 32)), ("Mixed_5c", _a(256, 64)), ("Mixed_5d", _a(288, 64)),
              ("Mixed_6a", _b(288)), ("Mixed_6b", _c(768, 128)), ("Mixed_6c", _c(768, 160)),
              ("Mixed_6d", _c(768, 160)), ("Mixed_6e", _c(768, 192)), ("Mixed_7a", _d(768)),
              ("Mixed_7b", _e(1280)), ("Mixed_7c", _e(2048))]
    for block, convs in blocks:
        shapes.update({f"{block}.{c}": s for c, s in convs.items()})
    return shapes


class InceptionV3(nn.Module):
    """The pool3 extractor with BatchNorm folded into its convolutions: one
    weight and bias a layer, under the layer's name with ``.`` as ``_``.
    ``forward`` takes an NCHW batch of 299x299 images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleDict({
            name.replace(".", "_"): nn.Conv2d(i, o, (kh, kw)) for name, (o, i, kh, kw) in layer_shapes().items()})

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, pad=(0, 0)) -> torch.Tensor:
        layer = self.convs[name.replace(".", "_")]
        return F.relu(F.conv2d(x, layer.weight, layer.bias, stride, pad))

    def block_a(self, blk, x):
        b5 = self.conv(f"{blk}.branch5x5_2", self.conv(f"{blk}.branch5x5_1", x), pad=(2, 2))
        b3 = self.conv(f"{blk}.branch3x3dbl_2", self.conv(f"{blk}.branch3x3dbl_1", x), pad=(1, 1))
        b3 = self.conv(f"{blk}.branch3x3dbl_3", b3, pad=(1, 1))
        bp = self.conv(f"{blk}.branch_pool", F.avg_pool2d(x, 3, 1, 1, count_include_pad=False))
        return torch.cat([self.conv(f"{blk}.branch1x1", x), b5, b3, bp], dim=1)

    def block_b(self, blk, x):
        bd = self.conv(f"{blk}.branch3x3dbl_2", self.conv(f"{blk}.branch3x3dbl_1", x), pad=(1, 1))
        bd = self.conv(f"{blk}.branch3x3dbl_3", bd, stride=2)
        return torch.cat([self.conv(f"{blk}.branch3x3", x, stride=2), bd, F.max_pool2d(x, 3, 2)], dim=1)

    def block_c(self, blk, x):
        b7 = self.conv(f"{blk}.branch7x7_1", x)
        b7 = self.conv(f"{blk}.branch7x7_3", self.conv(f"{blk}.branch7x7_2", b7, pad=(0, 3)), pad=(3, 0))
        bd = self.conv(f"{blk}.branch7x7dbl_1", x)
        for i, pad in ((2, (3, 0)), (3, (0, 3)), (4, (3, 0)), (5, (0, 3))):
            bd = self.conv(f"{blk}.branch7x7dbl_{i}", bd, pad=pad)
        bp = self.conv(f"{blk}.branch_pool", F.avg_pool2d(x, 3, 1, 1, count_include_pad=False))
        return torch.cat([self.conv(f"{blk}.branch1x1", x), b7, bd, bp], dim=1)

    def block_d(self, blk, x):
        b3 = self.conv(f"{blk}.branch3x3_2", self.conv(f"{blk}.branch3x3_1", x), stride=2)
        b7 = self.conv(f"{blk}.branch7x7x3_1", x)
        b7 = self.conv(f"{blk}.branch7x7x3_3", self.conv(f"{blk}.branch7x7x3_2", b7, pad=(0, 3)), pad=(3, 0))
        b7 = self.conv(f"{blk}.branch7x7x3_4", b7, stride=2)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)

    def block_e(self, blk, x, max_pool: bool):
        b3 = self.conv(f"{blk}.branch3x3_1", x)
        b3 = torch.cat([self.conv(f"{blk}.branch3x3_2a", b3, pad=(0, 1)),
                        self.conv(f"{blk}.branch3x3_2b", b3, pad=(1, 0))], dim=1)
        bd = self.conv(f"{blk}.branch3x3dbl_2", self.conv(f"{blk}.branch3x3dbl_1", x), pad=(1, 1))
        bd = torch.cat([self.conv(f"{blk}.branch3x3dbl_3a", bd, pad=(0, 1)),
                        self.conv(f"{blk}.branch3x3dbl_3b", bd, pad=(1, 0))], dim=1)
        # Mixed_7c max-pools where torchvision averages: the TF export's quirk
        pooled = F.max_pool2d(x, 3, 1, 1) if max_pool else F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
        return torch.cat([self.conv(f"{blk}.branch1x1", x), b3, bd, self.conv(f"{blk}.branch_pool", pooled)], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv("Conv2d_1a_3x3", x, stride=2)
        x = self.conv("Conv2d_2b_3x3", self.conv("Conv2d_2a_3x3", x), pad=(1, 1))
        x = F.max_pool2d(x, 3, 2)
        x = self.conv("Conv2d_4a_3x3", self.conv("Conv2d_3b_1x1", x))
        x = F.max_pool2d(x, 3, 2)
        for blk in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self.block_a(blk, x)
        x = self.block_b("Mixed_6a", x)
        for blk in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self.block_c(blk, x)
        x = self.block_d("Mixed_7a", x)
        x = self.block_e("Mixed_7b", x, max_pool=False)
        x = self.block_e("Mixed_7c", x, max_pool=True)
        return x.mean(dim=(2, 3))


def from_state_dict(state_dict: Dict[str, np.ndarray]) -> InceptionV3:
    """An ``InceptionV3`` from a pytorch-fid or torchvision state dict
    (tensors or numpy arrays), each BatchNorm folded into its conv in
    float64."""
    net = InceptionV3()
    folded = {}
    for name in layer_shapes():
        try:
            w, gamma, beta, mean, var = (np.asarray(state_dict[f"{name}.{k}"], np.float64) for k in (
                "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"))
        except KeyError as e:
            raise ValueError(f"InceptionV3 state dict is missing {e.args[0]!r}: save the full module state_dict "
                             f"(pytorch_fid.inception.fid_inception_v3().state_dict() or torchvision "
                             f"inception_v3)") from None
        scale = gamma / np.sqrt(var + BN_EPS)
        key = name.replace(".", "_")
        folded[f"convs.{key}.weight"] = torch.from_numpy((w * scale[:, None, None, None]).astype(np.float32))
        folded[f"convs.{key}.bias"] = torch.from_numpy((beta - mean * scale).astype(np.float32))
    net.load_state_dict(folded)
    return net.eval()


def load_inception(path: str, device="cuda") -> InceptionV3:
    """The extractor of the weights at ``path`` (``.pth`` or ``.npz``), on
    ``device``."""
    return from_state_dict(read_state_dict(path)).to(device)


def resize_299(img: torch.Tensor) -> torch.Tensor:
    """(1, H, W, 3) in [0, 1] -> (1, 3, 299, 299) in [-1, 1]: bilinear,
    half-pixel centres, antialiased when it shrinks (``jax.image.resize``'s
    "bilinear")."""
    x = F.interpolate(img.permute(0, 3, 1, 2).float(), size=(SIZE, SIZE), mode="bilinear", align_corners=False,
                      antialias=True)
    return x * 2.0 - 1.0


@torch.inference_mode()
def inception_pool3_features(net: InceptionV3, imgs: List[torch.Tensor]) -> torch.Tensor:
    """(B, 2048) pool3 features of a list of (1, H, W, 3) images in [0, 1]
    (each its own size), in one forward."""
    return net(torch.cat([resize_299(im) for im in imgs]))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)), pytorch-fid's
    numerics, with its eps jitter where sqrtm is not finite."""
    from scipy import linalg

    def sqrtm(a):
        out = linalg.sqrtm(a)  # a tuple from older scipy
        return out[0] if isinstance(out, tuple) else out

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


class FeatureStats:
    """Streaming mean and covariance of feature rows, float64, one pass."""

    def __init__(self, dim: int = FEATURES):
        self.n = 0
        self._sum = np.zeros(dim, np.float64)
        self._outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        self.n += feats.shape[0]
        self._sum += feats.sum(axis=0)
        self._outer += feats.T @ feats

    def stats(self):
        if self.n < 2:
            raise ValueError("FID needs at least 2 images per set")
        mu = self._sum / self.n
        # unbiased, as np.cov(feats, rowvar=False)
        sigma = (self._outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, sigma


class FIDMetric:
    """The set-level metric: ``update`` takes one (restored, GT) pair of
    uint8 RGB HWC images, ``result`` the FID of the set so far.  Images
    wait in a queue, resized to 299, and go through the network ``batch``
    at a time (``flush``)."""

    def __init__(self, path: str, device="cuda", batch: int = 16):
        self.device, self.batch = torch.device(device), batch
        self.net = load_inception(path, self.device)
        self.reset()

    def reset(self) -> None:
        self.out_stats, self.ref_stats = FeatureStats(), FeatureStats()
        self._queue: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def count(self) -> int:
        """Pairs taken since the last reset."""
        return self.out_stats.n + len(self._queue)

    def update(self, out_rgb: np.ndarray, gt_rgb: np.ndarray) -> None:
        self._queue.append(tuple(torch.from_numpy(np.ascontiguousarray(im)).to(self.device)[None].float() / 255.0
                                 for im in (out_rgb, gt_rgb)))
        if len(self._queue) >= self.batch:
            self.flush()

    def flush(self) -> None:
        """Features of the queued pairs, added to the statistics."""
        if self._queue:
            outs, gts = zip(*self._queue)
            self.out_stats.update(inception_pool3_features(self.net, list(outs)).double().cpu().numpy())
            self.ref_stats.update(inception_pool3_features(self.net, list(gts)).double().cpu().numpy())
            self._queue = []

    def result(self) -> float:
        self.flush()
        mu1, s1 = self.out_stats.stats()
        mu2, s2 = self.ref_stats.stats()
        return frechet_distance(mu1, s1, mu2, s2)


def fid_metric_from_env_or_arg(path: Optional[str], device="cuda") -> Optional[FIDMetric]:
    """``--fid-pth`` if given, else ``IRSDE_FID_PTH``; None when neither is
    set."""
    path = path or os.environ.get("IRSDE_FID_PTH")
    return FIDMetric(path, device) if path else None


def seeded_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A pytorch-fid InceptionV3 state dict with random weights from
    ``seed`` (convs ~ 1/sqrt(fan_in), BatchNorm near identity): for runs and
    tests where the published weights are not at hand."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in layer_shapes().items():
        o = shape[0]
        fan_in = shape[1] * shape[2] * shape[3]
        sd[f"{name}.conv.weight"] = torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5
        sd[f"{name}.bn.weight"] = 1.0 + 0.1 * torch.randn(o, generator=gen)
        sd[f"{name}.bn.bias"] = 0.1 * torch.randn(o, generator=gen)
        sd[f"{name}.bn.running_mean"] = 0.1 * torch.randn(o, generator=gen)
        sd[f"{name}.bn.running_var"] = 1.0 + 0.1 * torch.rand(o, generator=gen)
    return sd
