"""Denoising SDE: the mean-reverting SDE whose marginal mean is x0 itself
(PyTorch).

Counterpart of ``image_restoration_sde_tpu/sde/denoising_sde.py``: an
unconditional score model ``net(x, None, t)``, sigma^2 loss weights, and the
reverse chain started at the timestep that matches a given noise level
(``get_optimal_timestep``).  Every expression keeps the JAX package's
operation order, so float32 results agree to rounding.

Images are NHWC float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .schedules import ScheduleTables, tables_for


@dataclass(frozen=True)
class DenoisingSDE:
    tables: ScheduleTables

    @classmethod
    def create(
        cls,
        max_sigma: float,
        T: int,
        schedule: str = "cosine",
        eps: float = 0.04,
        device="cuda",
    ) -> "DenoisingSDE":
        """As the JAX package, unlike ``IRSDE.create``: ``max_sigma`` is
        divided by 255 only when strictly above 1, eps defaults to 0.04, and
        any schedule name other than "cosine" is the linear schedule."""
        max_sigma = max_sigma / 255.0 if max_sigma > 1 else float(max_sigma)
        if schedule != "cosine":
            schedule = "linear"
        return cls(tables=tables_for(max_sigma, T, schedule, eps, device))

    # ------------------------------------------------------------- lookups
    @property
    def T(self) -> int:
        return self.tables.T

    @property
    def dt(self) -> torch.Tensor:
        return self.tables.dt

    @property
    def max_sigma(self) -> torch.Tensor:
        return self.tables.max_sigma

    def theta(self, t):
        return self.tables.thetas[t]

    def sigma(self, t):
        return self.tables.sigmas[t]

    def theta_cumsum(self, t):
        return self.tables.thetas_cumsum[t]

    def sigma_bar(self, t):
        return self.tables.sigma_bars[t]

    # ---------------------------------------------------------------- math
    def mu_bar(self, x0, t):
        return x0

    def drift(self, x, x0, t):
        return self.theta(t) * (x0 - x) * self.dt

    def dispersion(self, noise, t):
        return self.sigma(t) * torch.sqrt(self.dt) * noise

    def sde_reverse_drift(self, score, t):
        """-(1/2) sigma_t^2 (1 + e^{-2 theta_cumsum_t dt}) score dt."""
        A = torch.exp(-2 * self.theta_cumsum(t) * self.dt)
        return -0.5 * self.sigma(t) ** 2 * (1 + A) * score * self.dt

    def ode_reverse_drift(self, score, t):
        A = torch.exp(-2 * self.theta_cumsum(t) * self.dt)
        return -0.5 * self.sigma(t) ** 2 * A * score * self.dt

    def reverse_sde_step(self, x, score, t, noise):
        return x - self.sde_reverse_drift(score, t) - self.dispersion(noise, t)

    def reverse_sde_step_mean(self, x, score, t):
        return x - self.sde_reverse_drift(score, t)

    def reverse_ode_step(self, x, score, t):
        return x - self.ode_reverse_drift(score, t)

    # ------------------------------------------------------- score algebra
    def score_from_noise(self, noise, t):
        return -noise / self.sigma_bar(t)

    def get_init_state_from_noise(self, x, noise, t):
        return x - self.sigma_bar(t) * noise

    def get_init_state_from_score(self, x, score, t):
        return x + self.sigma_bar(t) ** 2 * score

    def get_real_noise(self, xt, x0, t):
        return (xt - x0) / self.sigma_bar(t)

    def get_real_score(self, xt, x0, t):
        return -(xt - x0) / self.sigma_bar(t) ** 2

    def reverse_optimum_step(self, xt, x0, t):
        """Posterior mean of x_{t-1} | (x_t, x_0); the mean reverts to x0."""
        A = torch.exp(-self.theta(t) * self.dt)
        B = torch.exp(-self.theta_cumsum(t) * self.dt)
        C = torch.exp(-self.theta_cumsum(t - 1) * self.dt)
        term1 = A * (1 - C**2) / (1 - B**2)
        return term1 * (xt - x0) + x0

    def get_optimal_timestep(self, sigma: float, eps: float = 1e-6) -> int:
        """The schedule timestep whose marginal std is closest to ``sigma``
        (> 1: on the 0..255 scale), to start the reverse chain there.

        float32 on the CPU, in the JAX package's operation order, so both
        packages give the same integer (an off-by-one changes the chain's
        length)."""
        sigma = sigma / 255.0 if sigma > 1 else sigma
        f32 = torch.float32
        dt, max_sigma = self.dt.cpu(), self.max_sigma.cpu()
        ratio = torch.div(torch.tensor(sigma**2, dtype=f32), max_sigma**2)
        scale = torch.div(torch.tensor(-1.0, dtype=f32), 2 * dt)
        hat = scale * torch.log(1 - ratio + eps)
        return int(torch.argmin(torch.abs(self.tables.thetas_cumsum.cpu() - hat)))

    # ------------------------------------------------------------ training
    def weights(self, t):
        """sigma_t^2 loss weights."""
        return self.sigma(t) ** 2

    def generate_random_states(self, gen: torch.Generator, x0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-example t ~ U{1..T} and x_t = x0 + sigma_bar_t * noise.

        Returns ``(timesteps (B,1,1,1) int64, noisy_states NHWC f32)``."""
        batch = x0.shape[0]
        timesteps = torch.randint(1, self.T + 1, (batch, 1, 1, 1), generator=gen, device=x0.device)
        noises = torch.randn(x0.shape, generator=gen, dtype=torch.float32, device=x0.device)
        return timesteps, noises * self.sigma_bar(timesteps) + x0
