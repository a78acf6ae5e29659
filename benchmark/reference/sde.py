"""The mean-reverting IR-SDE in plain float32 PyTorch.

From the IR-SDE paper (Luo et al., ICML 2023, "Image Restoration with
Mean-Reverting Stochastic Differential Equations") and its repository's
``SDE`` class: dx = theta_t (mu - x) dt + sigma_t dW, the cosine theta
schedule, ``dt`` set so the terminal marginal std is ``max_sigma sqrt(1 -
eps^2)``; the reverse Euler-Maruyama step and the posterior (ancestral)
step.  Tables in float64, stored float32; ``max_sigma`` read on the 0..255
scale.

A chain draws ``T + 1`` normal tensors of the state's shape in turn, the
initial state's first and then one a step from t = T to 1.  The benchmark
makes those draws from its generators and hands the same ones to the
program and the reference.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch


class IRSDE:
    def __init__(self, max_sigma: float, T: int, schedule: str, eps: float, device):
        if schedule != "cosine":
            raise ValueError(f"the reference has the cosine schedule, not {schedule!r}")
        ms = max_sigma / 255.0 if max_sigma >= 1 else float(max_sigma)
        n = T + 2
        x = np.linspace(0, n, n + 1, dtype=np.float64)
        ac = np.cos(((x / n) + 0.008) / 1.008 * math.pi * 0.5) ** 2
        thetas = 1.0 - (ac / ac[0])[1:-1]
        sigmas = np.sqrt(ms**2 * 2.0 * thetas)
        cums = np.cumsum(thetas) - thetas[0]
        dt = -1.0 / cums[-1] * math.log(eps)
        sigma_bars = np.sqrt(ms**2 * (1.0 - np.exp(-2.0 * cums * dt)))

        def f32(a):
            return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

        self.T = int(T)
        self.thetas, self.sigmas, self.cums, self.sigma_bars = f32(thetas), f32(sigmas), f32(cums), f32(sigma_bars)
        self.dt, self.max_sigma = f32(dt), f32(ms)

    def score(self, noise, t):
        return -noise / self.sigma_bars[t]

    def sde_step(self, x, mu, noise_pred, t, z):
        drift = (self.thetas[t] * (mu - x) - self.sigmas[t] ** 2 * self.score(noise_pred, t)) * self.dt
        return x - drift - self.sigmas[t] * torch.sqrt(self.dt) * z

    def optimum_step(self, xt, x0, mu, t):
        A = torch.exp(-self.thetas[t] * self.dt)
        B = torch.exp(-self.cums[t] * self.dt)
        C = torch.exp(-self.cums[t - 1] * self.dt)
        return A * (1 - C**2) / (1 - B**2) * (xt - mu) + C * (1 - A**2) / (1 - B**2) * (x0 - mu) + mu

    def posterior_step(self, x, mu, noise_pred, t, z):
        x0 = (x - mu - self.sigma_bars[t] * noise_pred) * torch.exp(self.cums[t] * self.dt) + mu
        A = torch.exp(-2 * self.thetas[t] * self.dt)
        B = torch.exp(-2 * self.cums[t] * self.dt)
        C = torch.exp(-2 * self.cums[t - 1] * self.dt)
        var = (1 - A) * (1 - C) / (1 - B)
        std = torch.exp(0.5 * torch.log(torch.clamp(var, min=1e-20 * self.dt))) * self.max_sigma
        return self.optimum_step(x, x0, mu, t) + std * z

    def reverse(self, net, mu, noise, mode: str):
        """The reverse chain from ``mu + max_sigma noise[0]``, step t
        drawing ``noise[T + 1 - t]``; ``net(x, mu, tvec)``."""
        step = {"sde": self.sde_step, "posterior": self.posterior_step}[mode]
        x = mu + noise[0] * self.max_sigma
        for i, t in enumerate(range(self.T, 0, -1)):
            tvec = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
            x = step(x, mu, net(x, mu, tvec), t, noise[i + 1])
        return x



def truncated(sde: IRSDE, steps):
    """``sde`` whose chain runs ``steps`` steps (None: all of them)."""
    if steps is None:
        return sde
    short = copy.copy(sde)
    short.T = steps
    return short
