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

A train step captured as a CUDA graph (``training/captured.py``) replays
the update's device work, so nothing it reads may be a host value that
changes between calls.  On the card the learning rate is a float32 tensor
on the parameters' device that the update reads and the host writes before
each call (``ScheduledOptimizer.lr``), and Adam and AdamW run torch's
``capturable`` arithmetic in both forms, eager and captured: their step
counts and bias corrections are float32 tensors on the card, as optax
computes them in float32.  On the CPU (where ``capturable`` is refused)
Adam and AdamW read a Python float and take torch's default arithmetic
(bias corrections in float64); Lion reads the tensor on every device
(one float32 product either way).  A call's device work (:meth:`
ScheduledOptimizer.apply`) is apart from its host counts (:meth:`
ScheduledOptimizer.advance`), and each position in an accumulation cycle
divides by its own count, which a graph a position keeps.
"""

from __future__ import annotations

import warnings
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
            torch._foreach_mul_(update, group["lr"])
            torch._foreach_sub_(params, update)
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
    :class:`ScheduledOptimizer` before each update.  Adam and AdamW on the
    card are ``capturable`` (the module's docstring says why)."""
    name = (name or "Adam").lower()
    params = list(params)
    capturable = all(p.is_cuda for p in params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(beta1, beta2), eps=1e-8, weight_decay=weight_decay,
                                capturable=capturable)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(beta1, beta2), eps=1e-8, weight_decay=weight_decay,
                                 capturable=capturable)
    if name == "lion":
        return Lion(params, lr=0.0, betas=(beta1, beta2), weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r} (Adam | AdamW | Lion)")


class ScheduledOptimizer:
    """``inner`` with its learning rate read from ``schedule`` before each
    update, updating on every ``every_k``-th call of :meth:`step` with the
    mean of the gradients of those calls.  ``lr``: the float32 tensor on
    the parameters' device that the update reads (Lion's, and a capturable
    Adam's or AdamW's), else None (the update reads a Python float)."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Callable[[int], float], every_k: int = 1):
        self.inner, self.schedule, self.every_k = inner, schedule, every_k
        self.updates = 0  # updates made, the count the schedule is read at
        self.mini_step = 0  # calls accumulated since the last update
        self.acc = None
        reads_tensor = isinstance(inner, Lion) or all(g.get("capturable") for g in inner.param_groups)
        self.lr = torch.zeros((), dtype=torch.float32, device=self.params[0].device) if reads_tensor else None
        if self.lr is not None:
            for group in inner.param_groups:
                group["lr"] = self.lr

    @property
    def params(self) -> list:
        return [p for group in self.inner.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def write_lr(self) -> None:
        """Set the learning rate the next call's update reads: the
        schedule's at the count of updates made (nothing where that call
        only accumulates).  On the host, outside any graph: ``lr`` is
        written on its device."""
        if self.mini_step + 1 < self.every_k:
            return
        lr = self.schedule(self.updates)
        if self.lr is not None:
            self.lr.fill_(lr)
            return
        for group in self.inner.param_groups:
            group["lr"] = lr

    @torch.no_grad()
    def apply(self, position: int) -> None:
        """The device work of a call at ``position`` of the accumulation
        cycle (``mini_step``): take the gradients in ``p.grad`` (None reads
        as zeros, as a parameter the loss does not use gets a zero gradient
        in JAX), accumulate them, and update where the call completes
        ``every_k``, at the learning rate :meth:`write_lr` set.  Changes no
        host count (:meth:`advance`), so a graph can record it."""
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.every_k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in params]
            # the running mean acc + (g - acc) / (n + 1), as optax.MultiSteps
            delta = torch._foreach_sub([p.grad for p in params], self.acc)
            torch._foreach_div_(delta, position + 1)
            torch._foreach_add_(self.acc, delta)
            if position + 1 < self.every_k:
                return
            torch._foreach_copy_([p.grad for p in params], self.acc)
            torch._foreach_zero_(self.acc)
        with warnings.catch_warnings():  # torch's note that a capturable optimizer steps uncaptured
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            self.inner.step()

    def advance(self) -> bool:
        """Count one call whose device work :meth:`apply` did; returns
        whether it updated."""
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        self.mini_step = 0
        self.updates += 1
        return True

    def step(self) -> bool:
        """One call: :meth:`write_lr`, :meth:`apply`, :meth:`advance`.
        Returns whether it updated."""
        self.write_lr()
        self.apply(self.mini_step)
        return self.advance()

    def state_tensors(self) -> list:
        """Every tensor of the optimizer's state that an update reads or
        writes in place: the inner optimizer's per-parameter state, the
        accumulated gradients and ``lr``."""
        inner = [v for st in self.inner.state.values() for v in st.values() if torch.is_tensor(v)]
        return [*inner, *(self.acc or ()), *(() if self.lr is None else (self.lr,))]

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "updates": self.updates, "mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, sd: dict) -> None:
        """Load ``sd`` (written on any device).  The learning rate and
        ``capturable`` stay this optimizer's (the saved groups carry the
        writer's), and a capturable optimizer's step counts move to its
        parameters' device."""
        kept = [(g["lr"], g.get("capturable")) for g in self.inner.param_groups]
        self.inner.load_state_dict(sd["inner"])
        for group, (lr, capturable) in zip(self.inner.param_groups, kept):
            group["lr"] = lr
            if capturable is None:
                continue
            group["capturable"] = capturable
            for p in group["params"]:
                st = self.inner.state.get(p, {})
                if capturable and torch.is_tensor(st.get("step")):
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
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
