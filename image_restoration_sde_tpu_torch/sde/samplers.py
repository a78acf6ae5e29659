"""IR-SDE and denoising-SDE samplers as Python loops (PyTorch).

Counterpart of ``image_restoration_sde_tpu/sde/samplers.py``, where each
sampler is one ``lax.scan``.  Here the loop is Python, one network call per
step: eager on the CPU, and on the card recorded once per call signature
into a CUDA graph and replayed (``sde/captured.py``, through the samplers
of ``sampling.py``, ``training/latent.py`` and ``exporting.py``).  A replay
draws nothing: its chain reads its noise from a static buffer that
:func:`draw_noise` fills, before each replay, with the draws the eager
chain would make, in its order (:func:`reverse_from_noise`).

``noise_fn`` is the score network (``score = -noise / sigma_bar``):
``noise_fn(x, mu, tvec)`` for the IR-SDE samplers (conditional),
``noise_fn(x, tvec)`` for the ``dsde_*`` ones (unconditional); ``tvec`` is
an int ``(B,)`` tensor.

The stochastic samplers take either a generator (one, or one per sample) or
a pre-drawn ``noise_seq`` of shape ``(T, *x.shape)``, consumed in the
chain's order (t=T first in reverse, t=1 first in ``forward_sde``).
``noise_seq`` lets tests thread the same noise through this package and the
JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .denoising_sde import DenoisingSDE
from .irsde import IRSDE, noisy_start
from .rng import GeneratorLike, normal_like

Tensor = torch.Tensor
CondNoiseFn = Callable[[Tensor, Tensor, Tensor], Tensor]
UncondNoiseFn = Callable[[Tensor, Tensor], Tensor]


def tvec(batch: int, t: int, device) -> Tensor:
    """The (batch,) int32 timesteps the score nets take."""
    return torch.full((batch,), t, dtype=torch.int32, device=device)


def _times(x: Tensor, t):
    """``t`` as the net's (b,) timesteps and the schedule's index: ``t`` is
    an int (the eager loops) or the (b,) int32 timesteps (an exported
    step program, where each row indexes the tables)."""
    if isinstance(t, Tensor):
        return t, t.long().view(-1, 1, 1, 1)
    return tvec(x.shape[0], t, x.device), t


# One reverse step of each chain: the eager samplers below and the exported
# step programs (``exporting.RestorationStep`` / ``DenoisingStep``) run these.
def sde_step(sde: IRSDE, noise_fn: CondNoiseFn, x: Tensor, mu: Tensor, t, z: Tensor) -> Tensor:
    """Euler–Maruyama reverse step."""
    tv, ti = _times(x, t)
    return sde.reverse_sde_step(x, mu, sde.score_from_noise(noise_fn(x, mu, tv), ti), ti, z)


def posterior_step(sde: IRSDE, noise_fn: CondNoiseFn, x: Tensor, mu: Tensor, t, z: Tensor) -> Tensor:
    """DDPM-style ancestral (posterior) step."""
    tv, ti = _times(x, t)
    return sde.reverse_posterior_step(x, mu, noise_fn(x, mu, tv), ti, z)


def ode_step(sde: IRSDE, noise_fn: CondNoiseFn, x: Tensor, mu: Tensor, t, z: Optional[Tensor] = None) -> Tensor:
    """Probability-flow ODE step (``z`` unused)."""
    tv, ti = _times(x, t)
    return sde.reverse_ode_step(x, mu, sde.score_from_noise(noise_fn(x, mu, tv), ti), ti)


REVERSE_STEPS = {"sde": sde_step, "posterior": posterior_step, "ode": ode_step}


def dsde_ode_step(sde: DenoisingSDE, noise_fn: UncondNoiseFn, x: Tensor, t) -> Tensor:
    """The denoising SDE's reverse-ODE step."""
    tv, ti = _times(x, t)
    return sde.reverse_ode_step(x, sde.score_from_noise(noise_fn(x, tv), ti), ti)


def loop(step, x, ts, return_all=False):
    """Run ``step(x, t) -> x`` over the timesteps ``ts``."""
    states = []
    for t in ts:
        x = step(x, t)
        if return_all:
            states.append(x)
    return (x, torch.stack(states)) if return_all else x


def loop_with_noise(step, x, T, gen, noise_seq, return_all=False, ts=None):
    """Run ``step(x, t, z) -> x`` for t = T..1 (or over ``ts``), with ``z``
    from ``noise_seq`` (row i for the i-th timestep) or drawn from ``gen``."""
    ts = range(T, 0, -1) if ts is None else ts
    if noise_seq is not None and noise_seq.shape[0] != T:
        raise ValueError(f"noise_seq has {noise_seq.shape[0]} steps, expected {T}")
    zs = iter(noise_seq) if noise_seq is not None else None
    return loop(lambda x, t: step(x, t, next(zs) if zs is not None else normal_like(gen, x)),
                 x, ts, return_all)


def chain_draws(mode: str, steps: int) -> int:
    """The normal draws of a ``steps``-step reverse chain of ``mode`` from a
    noised start: the initial state's, then one a step (none for the ODE)."""
    return 1 if mode == "ode" else steps + 1


def draw_noise(gen: GeneratorLike, like: Tensor, n: int) -> Tensor:
    """``(n, *like.shape)``: ``n`` draws of ``normal_like(gen, like)`` in
    turn, the draws a chain that draws from ``gen`` makes, in its order (the
    initial state's first, then t = T..1); ``gen`` ends where that chain
    leaves it.  (One draw of ``n`` times the size is another stream.)"""
    return torch.stack([normal_like(gen, like) for _ in range(n)])


def reverse_from_noise(sde: IRSDE, noise_fn: CondNoiseFn, mu: Tensor, noise: Tensor, mode: str,
                       steps: Optional[int] = None) -> Tensor:
    """The reverse chain of ``mode`` from ``mu`` noised by ``noise[0]``
    (``IRSDE.noise_state``'s start), its step t drawing ``noise[T + 1 - t]``:
    with ``noise = draw_noise(gen, mu, chain_draws(mode, T))`` the chain
    that ``sde.noise_state(gen, mu)`` and ``reverse_*(..., gen)`` run, bit
    for bit.  What a captured chain records."""
    x = noisy_start(mu, noise[0], sde.max_sigma)
    if mode == "sde":
        return reverse_sde(sde, noise_fn, x, mu, steps=steps, noise_seq=noise[1:])
    if mode == "posterior":
        return reverse_posterior(sde, noise_fn, x, mu, steps=steps, noise_seq=noise[1:])
    return reverse_ode(sde, noise_fn, x, mu, steps=steps)


def forward_sde(
    sde: IRSDE,
    x0: Tensor,
    mu: Tensor,
    gen: Optional[GeneratorLike] = None,
    steps: Optional[int] = None,
    return_all: bool = False,
    noise_seq: Optional[Tensor] = None,
):
    """The forward mean-reverting SDE x0 -> x_T, t = 1..T (no network)."""
    T = sde.T if steps is None else steps
    return loop_with_noise(lambda x, t, z: sde.forward_step(x, mu, t, z), x0, T, gen, noise_seq,
                            return_all, ts=range(1, T + 1))


def reverse_sde(
    sde: IRSDE,
    noise_fn: CondNoiseFn,
    xt: Tensor,
    mu: Tensor,
    gen: Optional[GeneratorLike] = None,
    steps: Optional[int] = None,
    return_all: bool = False,
    noise_seq: Optional[Tensor] = None,
):
    """Euler–Maruyama reverse SDE, one net call per step."""
    T = sde.T if steps is None else steps
    return loop_with_noise(lambda x, t, z: sde_step(sde, noise_fn, x, mu, t, z), xt, T, gen, noise_seq, return_all)


def reverse_ode(
    sde: IRSDE,
    noise_fn: CondNoiseFn,
    xt: Tensor,
    mu: Tensor,
    steps: Optional[int] = None,
    return_all: bool = False,
):
    """Deterministic probability-flow ODE sampler."""
    T = sde.T if steps is None else steps
    return loop(lambda x, t: ode_step(sde, noise_fn, x, mu, t), xt, range(T, 0, -1), return_all)


def reverse_posterior(
    sde: IRSDE,
    noise_fn: CondNoiseFn,
    xt: Tensor,
    mu: Tensor,
    gen: Optional[GeneratorLike] = None,
    steps: Optional[int] = None,
    return_all: bool = False,
    noise_seq: Optional[Tensor] = None,
):
    """DDPM-style ancestral sampler (posterior sampling)."""
    T = sde.T if steps is None else steps
    return loop_with_noise(lambda x, t, z: posterior_step(sde, noise_fn, x, mu, t, z), xt, T, gen, noise_seq,
                           return_all)


def optimal_reverse(
    sde: IRSDE,
    xt: Tensor,
    x0: Tensor,
    mu: Tensor,
    steps: Optional[int] = None,
    return_all: bool = False,
):
    """The closed-form posterior-mean rollout from x_T to x_0 (no network)."""
    T = sde.T if steps is None else steps
    return loop(lambda x, t: sde.reverse_optimum_step(x, x0, mu, t), xt, range(T, 0, -1), return_all)


def ode_sampler(
    sde: IRSDE,
    noise_fn: CondNoiseFn,
    xt: Tensor,
    mu: Tensor,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    method: str = "RK45",
    eps: float = 1e-3,
) -> Tensor:
    """scipy's ``solve_ivp`` over the probability-flow ODE from t = T to
    ``eps``, on the host (float64 state, float32 drift on ``xt``'s device;
    the timestep is the solver's t truncated to an int).  Step control
    depends on the data, so this is a debugging tool, not a serving path."""
    from scipy import integrate

    shape, batch = xt.shape, xt.shape[0]

    @torch.inference_mode()
    def ode_func(t, x_flat):
        t = int(t)
        x = torch.from_numpy(x_flat.reshape(shape)).to(device=xt.device, dtype=torch.float32)
        score = sde.score_from_noise(noise_fn(x, mu, tvec(batch, t, xt.device)), t)
        return sde.ode_reverse_drift(x, mu, score, t).cpu().numpy().reshape(-1)

    x0 = xt.detach().cpu().numpy().reshape(-1).astype(np.float64)
    solution = integrate.solve_ivp(ode_func, (sde.T, eps), x0, rtol=rtol, atol=atol, method=method)
    return torch.from_numpy(solution.y[:, -1].reshape(shape)).to(device=xt.device, dtype=torch.float32)


# ------------------------------------------------------------- DenoisingSDE
def dsde_reverse_sde(
    sde: DenoisingSDE,
    noise_fn: Optional[UncondNoiseFn],
    xt: Tensor,
    gen: Optional[GeneratorLike] = None,
    x0: Optional[Tensor] = None,
    steps: Optional[int] = None,
    return_all: bool = False,
    noise_seq: Optional[Tensor] = None,
):
    """Reverse SDE of the denoising SDE; with ``x0`` given, the analytic
    score replaces the network."""
    T = sde.T if steps is None else steps
    batch = xt.shape[0]

    def step(x, t, z):
        if x0 is not None:
            score = sde.get_real_score(x, x0, t)
        else:
            score = sde.score_from_noise(noise_fn(x, tvec(batch, t, x.device)), t)
        return sde.reverse_sde_step(x, score, t, z)

    return loop_with_noise(step, xt, T, gen, noise_seq, return_all)


def dsde_reverse_ode(
    sde: DenoisingSDE,
    noise_fn: UncondNoiseFn,
    xt: Tensor,
    steps: Optional[int] = None,
    return_all: bool = False,
):
    """Deterministic reverse ODE of the denoising SDE: the denoising task's
    sampler, started at the optimal timestep for the input's noise level."""
    T = sde.T if steps is None else steps
    return loop(lambda x, t: dsde_ode_step(sde, noise_fn, x, t), xt, range(T, 0, -1), return_all)


def dsde_optimal_reverse(
    sde: DenoisingSDE,
    xt: Tensor,
    x0: Tensor,
    steps: Optional[int] = None,
    return_all: bool = False,
):
    """The denoising SDE's closed-form posterior-mean rollout (no network)."""
    T = sde.T if steps is None else steps
    return loop(lambda x, t: sde.reverse_optimum_step(x, x0, t), xt, range(T, 0, -1), return_all)
