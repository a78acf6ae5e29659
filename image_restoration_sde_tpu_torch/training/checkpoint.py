"""Checkpoints in the reference's torch format, with its resume semantics.

Counterpart of ``image_restoration_sde_tpu/training/checkpoint.py`` (orbax).
Parity: ref ``base_model.py:80-131`` + ``denoising_model.py:197-199``; each
save point writes

- ``<models>/{iter}_G.pth`` and, where the task keeps an EMA,
  ``<models>/lastest_EMA.pth`` (the reference's spelling): the net's and
  the EMA's ``state_dict`` in the reference key space, so either loads
  with ``load_state_dict`` and a reference ``.pth`` loads through
  :func:`load_params`;
- ``<training_state>/{iter}.state``: the step, epoch and iteration, the
  optimizer's state, the EMA's counter and parameters, the state of the
  run's generator and whatever the task adds (``extra``).

A run resumed from ``{iter}.state`` (with ``{iter}_G.pth`` loaded into the
net) continues as the uninterrupted run would.  Under data parallelism rank
0 writes (every rank holds the same state) and every rank loads, so a
checkpoint does not depend on the world size it was written at.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..parallel import dist
from .ema import EMA
from .trainer import TrainState


def _cpu(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def ema_state_dict(state: TrainState) -> dict:
    """The net's ``state_dict`` with the EMA's parameters in place of its own."""
    return {k: state.ema.params.get(k, v) for k, v in state.net.state_dict().items()}


def save_params(models_dir: str, state_dict: dict, label: str) -> str:
    os.makedirs(models_dir, exist_ok=True)
    path = os.path.join(models_dir, f"{label}.pth")
    torch.save(_cpu(state_dict), path)
    return path


def load_params(path: str) -> dict:
    """A ``state_dict`` from a ``.pth`` on the host; a ``module.`` prefix
    (a reference net saved from DataParallel) is dropped, as the reference's
    ``load_network`` does."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def save_training_state(training_state_dir: str, state: TrainState, epoch: int, iter_step: int,
                        generator: torch.Generator, extra: Optional[dict] = None) -> str:
    os.makedirs(training_state_dir, exist_ok=True)
    path = os.path.join(training_state_dir, f"{iter_step}.state")
    torch.save({
        "step": state.step, "epoch": epoch, "iter": iter_step,
        "optimizer": state.optimizer.state_dict(),
        "ema": None if state.ema is None else {"step": state.ema.step, "params": _cpu(state.ema.params)},
        "generator": generator.get_state(),
        "extra": extra or {},
    }, path)
    return path


def load_training_state(path: str, state: TrainState, generator: torch.Generator) -> Tuple[int, int, dict]:
    """Restore ``state`` (step, optimizer, EMA) and ``generator`` in place
    from ``{iter}.state``; the net's own weights come from ``{iter}_G.pth``.
    Returns ``(epoch, iter, extra)``."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state.step = int(ck["step"])
    state.optimizer.load_state_dict(ck["optimizer"])
    device = next(state.net.parameters()).device
    if ck["ema"] is not None:
        state.ema = EMA({k: v.to(device) for k, v in ck["ema"]["params"].items()}, int(ck["ema"]["step"]))
    generator.set_state(ck["generator"])
    return int(ck["epoch"]), int(ck["iter"]), ck["extra"]


def save_checkpoint(opt_path: dict, state: TrainState, epoch: int, iter_step: int,
                    generator: torch.Generator, extra: Optional[dict] = None) -> None:
    """Full save point (ref train.py:305-309): weights, EMA, trainer state;
    written by rank 0 while the other ranks wait at a barrier."""
    if dist.process_is_primary():
        save_params(opt_path["models"], state.net.state_dict(), f"{iter_step}_G")
        if state.ema is not None:
            save_params(opt_path["models"], ema_state_dict(state), "lastest_EMA")
        save_training_state(opt_path["training_state"], state, epoch, iter_step, generator, extra)
    dist.barrier()
