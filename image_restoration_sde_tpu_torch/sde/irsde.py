"""Mean-reverting IR-SDE:  dx = theta_t (mu - x) dt + sigma_t dW  (PyTorch).

Counterpart of ``image_restoration_sde_tpu/sde/irsde.py``.  The terminal
mean ``mu`` (the LQ image) and the score network are explicit arguments, and
noise is passed in or drawn from an explicit generator.  Timesteps ``t`` are
python ints or int tensors of any broadcastable shape (a scalar at sampling
time, ``(B,1,1,1)`` at training time); coefficient lookups index the
float32 tables.  Every expression keeps the JAX package's operation order,
so float32 results agree to rounding.

Images are NHWC float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .rng import GeneratorLike, draw_states, normal_like
from .schedules import ScheduleTables, build_tables


def noisy_start(x: torch.Tensor, z: torch.Tensor, max_sigma: torch.Tensor) -> torch.Tensor:
    """A reverse chain's initial state: x + max_sigma * z."""
    return x + z * max_sigma


@dataclass(frozen=True)
class IRSDE:
    tables: ScheduleTables

    @classmethod
    def create(
        cls,
        max_sigma: float,
        T: int = 100,
        schedule: str = "cosine",
        eps: float = 0.01,
        device="cuda",
    ) -> "IRSDE":
        return cls(tables=build_tables(max_sigma, T, schedule, eps, device=device))

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
        """Marginal std of x_t given x_0."""
        return self.tables.sigma_bars[t]

    # -------------------------------------------------------- forward math
    def mu_bar(self, x0, mu, t):
        """Marginal mean of x_t: mu + (x0-mu) e^{-theta_cumsum_t dt}."""
        return mu + (x0 - mu) * torch.exp(-self.theta_cumsum(t) * self.dt)

    def drift(self, x, mu, t):
        return self.theta(t) * (mu - x) * self.dt

    def dispersion(self, noise, t):
        return self.sigma(t) * torch.sqrt(self.dt) * noise

    def forward_step(self, x, mu, t, noise):
        """Euler–Maruyama forward step."""
        return x + self.drift(x, mu, t) + self.dispersion(noise, t)

    # ------------------------------------------------------- score algebra
    def score_from_noise(self, noise, t):
        return -noise / self.sigma_bar(t)

    def get_real_noise(self, xt, x0, mu, t):
        return (xt - self.mu_bar(x0, mu, t)) / self.sigma_bar(t)

    def get_real_score(self, xt, x0, mu, t):
        return -(xt - self.mu_bar(x0, mu, t)) / self.sigma_bar(t) ** 2

    def get_init_state_from_noise(self, xt, mu, noise, t):
        """Estimate x0 from a noise prediction."""
        A = torch.exp(self.theta_cumsum(t) * self.dt)
        return (xt - mu - self.sigma_bar(t) * noise) * A + mu

    # ------------------------------------------------------- reverse steps
    def sde_reverse_drift(self, x, mu, score, t):
        return (self.theta(t) * (mu - x) - self.sigma(t) ** 2 * score) * self.dt

    def ode_reverse_drift(self, x, mu, score, t):
        """Probability-flow ODE drift (0.5 sigma^2)."""
        return (self.theta(t) * (mu - x) - 0.5 * self.sigma(t) ** 2 * score) * self.dt

    def reverse_sde_step_mean(self, x, mu, score, t):
        return x - self.sde_reverse_drift(x, mu, score, t)

    def reverse_sde_step(self, x, mu, score, t, noise):
        return x - self.sde_reverse_drift(x, mu, score, t) - self.dispersion(noise, t)

    def reverse_ode_step(self, x, mu, score, t):
        return x - self.ode_reverse_drift(x, mu, score, t)

    def reverse_optimum_step(self, xt, x0, mu, t):
        """Closed-form posterior mean of x_{t-1} | (x_t, x_0)."""
        A = torch.exp(-self.theta(t) * self.dt)
        B = torch.exp(-self.theta_cumsum(t) * self.dt)
        C = torch.exp(-self.theta_cumsum(t - 1) * self.dt)
        term1 = A * (1 - C**2) / (1 - B**2)
        term2 = C * (1 - A**2) / (1 - B**2)
        return term1 * (xt - mu) + term2 * (x0 - mu) + mu

    def reverse_optimum_std(self, t):
        """Posterior std with log-clamped variance."""
        A = torch.exp(-2 * self.theta(t) * self.dt)
        B = torch.exp(-2 * self.theta_cumsum(t) * self.dt)
        C = torch.exp(-2 * self.theta_cumsum(t - 1) * self.dt)
        posterior_var = (1 - A) * (1 - C) / (1 - B)
        min_value = 1e-20 * self.dt
        log_var = torch.log(torch.clamp(posterior_var, min=min_value))
        return torch.exp(0.5 * log_var) * self.max_sigma

    def reverse_posterior_step(self, xt, mu, noise_pred, t, noise):
        """DDPM-style ancestral step."""
        x0 = self.get_init_state_from_noise(xt, mu, noise_pred, t)
        mean = self.reverse_optimum_step(xt, x0, mu, t)
        std = self.reverse_optimum_std(t)
        return mean + std * noise

    # ------------------------------------------------------------ training
    def weights(self, t):
        return torch.exp(-self.theta_cumsum(t) * self.dt)

    def draw_states(self, gen: torch.Generator, x0: torch.Tensor, shard: Optional[tuple] = None) -> tuple:
        """``(timesteps, noises)`` of a train step on ``x0`` (``rng.draw_states``)."""
        return draw_states(gen, self.T, x0, shard)

    def compose_states(self, x0: torch.Tensor, mu: torch.Tensor, timesteps: torch.Tensor,
                       noises: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(timesteps, x_t)``: the noisy states of :meth:`draw_states`' draws."""
        state_mean = self.mu_bar(x0, mu, timesteps)
        noisy_states = noises * self.sigma_bar(timesteps) + state_mean
        return timesteps, noisy_states.float()

    def generate_random_states(
        self, gen: torch.Generator, x0: torch.Tensor, mu: torch.Tensor, shard: Optional[tuple] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample per-example t ~ U{1..T} and the matching noisy state x_t:
        :meth:`compose_states` of :meth:`draw_states`.

        ``shard = (rank, world)``: ``x0`` and ``mu`` are rank's rows of a
        global batch of ``world`` times as many; the draws are the global
        batch's (what one process would draw), of which these rows are kept.

        Returns ``(timesteps (B,1,1,1) int64, noisy_states NHWC f32)``.
        """
        return self.compose_states(x0, mu, *self.draw_states(gen, x0, shard))

    def noise_state(self, gen: GeneratorLike, x: torch.Tensor) -> torch.Tensor:
        """Test-time init: x + max_sigma * eps (per sample with a generator
        sequence)."""
        return noisy_start(x, normal_like(gen, x), self.max_sigma)
