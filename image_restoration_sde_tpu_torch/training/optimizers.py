"""Optimizers: Adam, AdamW and Lion, with the LR read from a schedule on
every update and optional gradient accumulation.

Counterpart of ``image_restoration_sde_tpu/training/optimizers.py`` (optax).
Parity: ref ``denoising_model.py:68-91`` — Adam / AdamW / Lion selected by
``train.optimizer`` with lr_G, (beta1, beta2), weight_decay_G.

- Adam's ``weight_decay`` is L2 folded into the gradient before the moment
  updates, as ``torch.optim.Adam(weight_decay=)`` does (optax:
  ``add_decayed_weights`` ahead of ``scale_by_adam``).
- AdamW is decoupled decay (``torch.optim.AdamW``; ``optax.adamw``).
- :class:`Lion` follows ``optax.lion``'s update order; torch has none.

:class:`ScheduledOptimizer` sets the learning rate from the schedule before
each update, at the count of updates made so far (the first update reads it
at 0, as optax's ``scale_by_schedule``), and with ``every_k`` > 1 averages
the gradients of k calls and updates on every k-th (``optax.MultiSteps``:
the schedule advances per update).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


class Lion(torch.optim.Optimizer):
    """Lion (Chen et al. 2023) in ``optax.lion``'s order: the update is
    ``sign((1 - b1) g + b1 m) + weight_decay * p``, scaled by ``-lr``; then
    ``m = (1 - b2) g + b2 m``.  Each step is a few multi-tensor operations
    over all parameters (one launch per operation and chunk of tensors, not
    per parameter)."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
            ms = [self.state[p]["exp_avg"] for p in params]
            update = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(update, torch._foreach_mul(ms, b1))
            torch._foreach_sign_(update)
            if group["weight_decay"]:
                torch._foreach_add_(update, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(update, -group["lr"])
            torch._foreach_add_(params, update)
            torch._foreach_mul_(ms, b2)
            torch._foreach_add_(ms, torch._foreach_mul(grads, 1.0 - b2))


def build_optimizer(
    name: str,
    params: Iterable[torch.Tensor],
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 0.0,
) -> torch.optim.Optimizer:
    """Adam | AdamW | Lion over ``params``; its learning rate is set by
    :class:`ScheduledOptimizer` before each update."""
    name = (name or "Adam").lower()
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(beta1, beta2), eps=1e-8, weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(beta1, beta2), eps=1e-8, weight_decay=weight_decay)
    if name == "lion":
        return Lion(params, lr=0.0, betas=(beta1, beta2), weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r} (Adam | AdamW | Lion)")


class ScheduledOptimizer:
    """``inner`` with its learning rate read from ``schedule`` before each
    update, updating on every ``every_k``-th call of :meth:`step` with the
    mean of the gradients of those calls."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Callable[[int], float], every_k: int = 1):
        self.inner, self.schedule, self.every_k = inner, schedule, every_k
        self.updates = 0  # updates made, the count the schedule is read at
        self.mini_step = 0  # calls accumulated since the last update
        self.acc = None

    @property
    def params(self) -> list:
        return [p for group in self.inner.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> bool:
        """Take the gradients in ``p.grad`` (None reads as zeros, as a
        parameter the loss does not use gets a zero gradient in JAX); update
        the parameters where this call completes ``every_k``.  Returns
        whether it updated."""
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.every_k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in params]
            # the running mean acc + (g - acc) / (n + 1), as optax.MultiSteps
            delta = torch._foreach_sub([p.grad for p in params], self.acc)
            torch._foreach_div_(delta, self.mini_step + 1)
            torch._foreach_add_(self.acc, delta)
            self.mini_step += 1
            if self.mini_step < self.every_k:
                return False
            torch._foreach_copy_([p.grad for p in params], self.acc)
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        lr = self.schedule(self.updates)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "updates": self.updates, "mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        self.updates, self.mini_step = int(sd["updates"]), int(sd["mini_step"])
        if sd["acc"] is None:
            self.acc = None
        else:
            self.acc = [a.to(p.device) for a, p in zip(sd["acc"], self.params)]


def build_from_options(train_opt: dict, params: Iterable[torch.Tensor],
                       schedule: Callable[[int], float]) -> ScheduledOptimizer:
    """Build from a reference-format ``train:`` dict (YAML surface parity);
    ``train.grad_accum: k`` (the JAX package's, absent upstream) averages
    gradients over k calls and updates on every k-th."""
    inner = build_optimizer(
        train_opt.get("optimizer") or "Adam",
        params,
        beta1=float(train_opt.get("beta1") or 0.9),
        beta2=float(train_opt.get("beta2") or 0.999),
        weight_decay=float(train_opt.get("weight_decay_G") or 0.0),
    )
    return ScheduledOptimizer(inner, schedule, int(train_opt.get("grad_accum") or 1))
