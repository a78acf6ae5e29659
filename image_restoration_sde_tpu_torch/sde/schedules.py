"""Theta schedules and precomputed SDE coefficient tables (PyTorch).

Counterpart of ``image_restoration_sde_tpu/sde/schedules.py``: the builders
run in numpy float64 with the same math, and the tables are stored as
float32 tensors on an explicit device.

Timestep convention: ``t`` runs 1..T and every table has ``T+1`` entries so
timestep values index directly; ``thetas_cumsum[0] == 0`` and entry 0 of
``sigma_bars`` is 0 (state 0 is never used).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def constant_theta_schedule(T: int, v: float = 1.0) -> np.ndarray:
    """theta_t = v for t in 0..T."""
    return np.full(T + 1, v, dtype=np.float64)


def linear_theta_schedule(T: int) -> np.ndarray:
    """DDPM-style linear beta range rescaled by 1000/(T+1)."""
    n = T + 1
    scale = 1000.0 / n
    return np.linspace(scale * 0.0001, scale * 0.02, n, dtype=np.float64)


def cosine_theta_schedule(T: int, s: float = 0.008) -> np.ndarray:
    """Nichol–Dhariwal cosine schedule, truncated to T+1 entries.

    Uses ``betas = 1 - alphas_cumprod[1:-1]`` (cumulative, not ratio form).
    """
    n = T + 2
    x = np.linspace(0, n, n + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / n) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    return 1.0 - alphas_cumprod[1:-1]


_SCHEDULES = {
    "constant": constant_theta_schedule,
    "linear": linear_theta_schedule,
    "cosine": cosine_theta_schedule,
}


def make_theta_schedule(name: str, T: int) -> np.ndarray:
    try:
        return _SCHEDULES[name](T)
    except KeyError:
        raise ValueError(
            f"unknown theta schedule {name!r}; available: {sorted(_SCHEDULES)}"
        ) from None


@dataclass(frozen=True)
class ScheduleTables:
    """Precomputed SDE coefficients, float32 tensors on one device."""

    thetas: torch.Tensor  # (T+1,)
    sigmas: torch.Tensor  # (T+1,) sqrt(2 theta max_sigma^2)
    thetas_cumsum: torch.Tensor  # (T+1,) cumsum shifted so [0] == 0
    sigma_bars: torch.Tensor  # (T+1,) marginal std at t
    dt: torch.Tensor  # ()
    max_sigma: torch.Tensor  # () already /255-normalised
    T: int


def build_tables(
    max_sigma: float,
    T: int,
    schedule: str = "cosine",
    eps: float = 0.01,
    device="cuda",
) -> ScheduleTables:
    """Build :class:`ScheduleTables`: float64 math, stored float32.

    ``max_sigma`` >= 1 is read on the 0..255 scale and divided by 255.
    ``dt`` is recomputed from ``eps`` so the terminal marginal std approaches
    ``max_sigma * sqrt(1 - eps^2)``.
    """
    max_sigma = max_sigma / 255.0 if max_sigma >= 1 else float(max_sigma)
    return tables_for(max_sigma, T, schedule, eps, device)


def tables_for(max_sigma: float, T: int, schedule: str, eps: float, device) -> ScheduleTables:
    """:class:`ScheduleTables` for a ``max_sigma`` already on the 0..1 scale."""
    thetas = make_theta_schedule(schedule, T)
    sigmas = np.sqrt(max_sigma**2 * 2.0 * thetas)
    thetas_cumsum = np.cumsum(thetas) - thetas[0]  # thetas[0] is not 0
    dt = -1.0 / thetas_cumsum[-1] * math.log(eps)
    sigma_bars = np.sqrt(max_sigma**2 * (1.0 - np.exp(-2.0 * thetas_cumsum * dt)))

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return ScheduleTables(
        thetas=f32(thetas),
        sigmas=f32(sigmas),
        thetas_cumsum=f32(thetas_cumsum),
        sigma_bars=f32(sigma_bars),
        dt=f32(dt),
        max_sigma=f32(max_sigma),
        T=int(T),
    )
