"""Exponential moving average of parameters, with ema_pytorch's semantics.

Counterpart of ``image_restoration_sde_tpu/training/ema.py``.  The
reference wraps its model in ``ema_pytorch.EMA(model, beta=0.995,
update_every=10)`` (ref denoising_model.py:118) and calls ``.update()`` once
per optimizer step (denoising_model.py:145).  With its defaults
(update_after_step=100, inv_gamma=1.0, power=2/3, min_value=0):

- the counter increments on every call; the EMA moves only when
  ``step % update_every == 0``;
- while ``step <= update_after_step`` the EMA is a plain copy of the params;
- afterwards the decay ramps: ``d = 1 - (1 + epoch/inv_gamma)^(-power)``
  with ``epoch = step - update_after_step - 1``, clamped to
  ``[min_value, beta]`` (and 0 when epoch <= 0);
- ``ema = d * ema + (1-d) * params``, in float32, on update rounds only.

The decay is computed in float32, in the JAX package's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

_F32 = np.float32


@dataclass(frozen=True)
class EmaConfig:
    beta: float = 0.995
    update_every: int = 10
    update_after_step: int = 100
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0
    min_value: float = 0.0


def current_decay(step: int, cfg: EmaConfig) -> float:
    epoch = max(_F32(step) - _F32(cfg.update_after_step) - _F32(1.0), _F32(0.0))
    value = _F32(1.0) - (_F32(1.0) + epoch / _F32(cfg.inv_gamma)) ** _F32(-cfg.power)
    value = min(max(value, _F32(cfg.min_value)), _F32(cfg.beta))
    return 0.0 if epoch <= 0 else float(value)


class EMA:
    """The EMA parameters (name -> tensor, copies) and the count of
    :meth:`update` calls."""

    def __init__(self, params: Mapping[str, torch.Tensor], step: int = 0):
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.step = step

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], cfg: EmaConfig = EmaConfig()) -> None:
        """One ``EMA.update()`` call (once per train step); the EMA and the
        parameters are float32, blended with multi-tensor operations."""
        step = self.step
        if step % cfg.update_every == 0:
            # while warming up (or on the first live round), decay 0: a plain copy
            decay = 0.0 if step <= cfg.update_after_step else current_decay(step, cfg)
            ema = list(self.params.values())
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, torch._foreach_mul([params[k].detach() for k in self.params], 1.0 - decay))
        self.step = step + 1
