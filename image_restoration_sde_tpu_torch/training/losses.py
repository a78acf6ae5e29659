"""Training losses (PyTorch).

Counterpart of ``image_restoration_sde_tpu/training/losses.py``.  Parity:
``codes/config/deraining/models/modules/loss.py:9-29`` (MatchingLoss) —
elementwise L1/L2 reduced to a per-sample mean, optionally multiplied by
per-sample timestep weights, then averaged over the batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def matching_loss(
    predict: torch.Tensor,
    target: torch.Tensor,
    loss_type: str = "l1",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if loss_type == "l1":
        per_elem = (predict - target).abs()
    elif loss_type == "l2":
        per_elem = (predict - target) ** 2
    else:
        raise ValueError(f"invalid loss type {loss_type!r}")
    per_sample = per_elem.reshape(per_elem.shape[0], -1).mean(dim=1)
    if weights is not None:
        per_sample = weights.reshape(-1) * per_sample
    return per_sample.mean()


def perceptual_matching_loss(
    predict: torch.Tensor,
    target: torch.Tensor,
    loss_type: str = "l1",
    weights: Optional[torch.Tensor] = None,
    lpips_weight: float = 0.01,
    lpips_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """MatchingLoss + lpips_weight * LPIPS.

    Parity: ref config/unet-latent/models/modules/loss.py:34-58
    (PerceptualMatchingLoss; the shipped code path uses the plain
    MatchingLoss).  ``lpips_fn(predict, target)`` is injectable and returns
    the batch mean, e.g. ``utils.lpips.make_perceptual_loss_fn(pth)``
    (differentiable); without it the perceptual term is skipped, which is
    the reference's effective behaviour."""
    loss = matching_loss(predict, target, loss_type, weights)
    if lpips_fn is not None:
        loss = loss + lpips_weight * lpips_fn(predict, target)
    return loss
