"""Learning-rate schedules as plain ``step -> lr`` functions.

Counterpart of ``image_restoration_sde_tpu/training/lr_schedules.py`` in
plain Python and numpy: the optimizer (``training.optimizers``) reads the
schedule once per update, at the count of updates made before it, so the
first update reads it at 0, as optax's ``scale_by_schedule`` does.

Parity targets:

- ``MultiStepLR_Restart`` (ref models/lr_scheduler.py:8-44).  The
  reference's ``get_lr`` multiplies by a hardcoded 0.5 and ignores the ctor
  gamma; with the shipped configs (``lr_gamma: 0.5``) the effective decay is
  0.5, which is what this reproduces; the ``gamma`` argument is honoured.
- ``CosineAnnealingLR_Restart`` (ref lr_scheduler.py:47-91).
- torch ``CosineAnnealingLR`` ("TrueCosineAnnealingLR" in the YAML,
  ref denoising_model.py:107-114).
- Linear warmup override (ref base_model.py:52-64): for
  ``step < warmup_iter`` the LR is ``init_lr * step / warmup_iter``,
  overriding the scheduler output.

Each value is computed in float32, in the JAX package's operation order.
"""

from __future__ import annotations

import bisect
from typing import Callable, Optional, Sequence

import numpy as np

Schedule = Callable[[int], float]
_F32 = np.float32


def multistep_restart(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.5,
    restarts: Optional[Sequence[int]] = None,
    restart_weights: Optional[Sequence[float]] = None,
) -> Schedule:
    """Step decay by ``gamma`` at each milestone, with optional restarts that
    reset the LR to ``base_lr * weight`` and forget prior decays."""
    milestones = sorted(int(m) for m in milestones)
    restarts_list = [int(r) for r in restarts or []]
    weights_list = list(restart_weights or [1.0] * len(restarts_list))
    if len(restarts_list) != len(weights_list):
        raise ValueError("restarts and their weights do not match")
    if 0 not in restarts_list:
        restarts_list = [0] + restarts_list
        weights_list = [1.0] + weights_list
    order = np.argsort(restarts_list)
    starts = [restarts_list[i] for i in order]
    weights = [_F32(weights_list[i]) for i in order]

    def schedule(step: int) -> float:
        k = max(0, bisect.bisect_right(starts, step) - 1)  # last restart at or before step
        n_decays = sum(1 for m in milestones if starts[k] < m <= step)
        return float(_F32(base_lr) * weights[k] * _F32(gamma) ** _F32(n_decays))

    return schedule


def cosine_annealing_restart(
    base_lr: float,
    t_periods: Sequence[int],
    eta_min: float = 0.0,
    restarts: Optional[Sequence[int]] = None,
    restart_weights: Optional[Sequence[float]] = None,
) -> Schedule:
    """Per-period cosine annealing with restart weights: within period k
    starting at restart R_k with length T_k,
    lr = eta_min + (base*w_k - eta_min) * (1+cos(pi (s-R_k)/T_k))/2."""
    restarts = [int(r) for r in restarts or []]
    starts = [0] + restarts
    periods = [_F32(p) for p in t_periods]
    weights = [_F32(w) for w in [1.0] + list(restart_weights or [1.0] * len(restarts))]
    if not (len(starts) == len(periods) == len(weights)):
        raise ValueError("t_periods / restarts / weights lengths mismatch")

    def schedule(step: int) -> float:
        k = min(max(0, bisect.bisect_right(starts, step) - 1), len(periods) - 1)
        frac = _F32(step - starts[k]) / periods[k]
        cos = _F32(np.cos(_F32(np.pi) * frac))
        return float(_F32(eta_min) + (_F32(base_lr) * weights[k] - _F32(eta_min)) * (1 + cos) / 2)

    return schedule


def true_cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0) -> Schedule:
    """torch CosineAnnealingLR closed form (the Refusion configs' scheduler)."""

    def schedule(step: int) -> float:
        frac = _F32(step) / _F32(t_max)
        cos = _F32(np.cos(_F32(np.pi) * frac))
        return float(_F32(eta_min) + (_F32(base_lr) - _F32(eta_min)) * (1 + cos) / 2)

    return schedule


def with_warmup(schedule: Schedule, base_lr: float, warmup_iter: Optional[int]) -> Schedule:
    """Linear warmup override for the first ``warmup_iter`` steps: warmup
    scales the initial LR, not the scheduler output."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def warmed(step: int) -> float:
        if step < warmup_iter:
            return float(_F32(base_lr) * _F32(step) / _F32(warmup_iter))
        return schedule(step)

    return warmed


def build_lr_schedule(train_opt: dict) -> Schedule:
    """Build the schedule from a reference-format ``train:`` options dict.

    YAML surface: lr_scheme (MultiStepLR | TrueCosineAnnealingLR |
    CosineAnnealingLR_Restart), lr_G, lr_steps, lr_gamma, restarts,
    restart_weights, niter, eta_min, warmup_iter, T_period.
    Ref: denoising_model.py:94-116.
    """
    base_lr = float(train_opt["lr_G"])
    scheme = train_opt.get("lr_scheme", "MultiStepLR")
    if scheme == "MultiStepLR":
        sched = multistep_restart(
            base_lr,
            train_opt.get("lr_steps") or [],
            gamma=float(train_opt.get("lr_gamma") or 0.5),
            restarts=train_opt.get("restarts"),
            restart_weights=train_opt.get("restart_weights"),
        )
    elif scheme == "TrueCosineAnnealingLR":
        sched = true_cosine_annealing(
            base_lr, int(train_opt["niter"]), float(train_opt.get("eta_min") or 0.0)
        )
    elif scheme == "CosineAnnealingLR_Restart":
        sched = cosine_annealing_restart(
            base_lr,
            train_opt["T_period"],
            eta_min=float(train_opt.get("eta_min") or 0.0),
            restarts=train_opt.get("restarts"),
            restart_weights=train_opt.get("restart_weights"),
        )
    else:
        raise NotImplementedError(f"lr_scheme {scheme!r}")
    warmup = train_opt.get("warmup_iter") or -1
    return with_warmup(sched, base_lr, int(warmup))
