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
checkpoint does not depend on the world size it was written at.  Under
tensor parallelism (``state.layout``) rank 0's model group assembles the
whole tensors (parameters, EMA, the optimizer's moments) and rank 0 writes
them in the same key space; every rank reads the whole file and keeps its
slice.  So checkpoints are layout-portable: one process's save resumes a
split run and back.
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


def _optimizer_tensors(state: TrainState, sd: dict, convert) -> dict:
    """The optimizer ``state_dict`` ``sd`` with its per-parameter tensors (the
    moments, the accumulated gradients) converted by ``convert`` (``{name:
    tensor} -> {name: tensor}``, a ``Layout``'s ``shard`` or ``whole``), the
    step counts as they are.  The optimizer holds the net's parameters in
    ``named_parameters``' order; the conversions go in one order on every
    rank."""
    names = [n for n, _ in state.net.named_parameters()]
    per_param = {i: dict(st) for i, st in sd["inner"]["state"].items()}
    for key in sorted({k for st in per_param.values() for k, v in st.items() if torch.is_tensor(v) and v.dim()}):
        held = [i for i, st in per_param.items() if key in st]
        converted = convert({names[i]: per_param[i][key] for i in held})
        for i in held:
            per_param[i][key] = converted[names[i]]
    acc = None if sd["acc"] is None else list(convert(dict(zip(names, sd["acc"]))).values())
    return {**sd, "inner": {**sd["inner"], "state": per_param}, "acc": acc}


def whole_state(state: TrainState) -> dict:
    """The train state's tensors in the whole (reference) key space: the
    net's ``state_dict`` (``net``), the EMA's parameters (``ema``, None
    without an EMA) and the optimizer's ``state_dict`` (``optimizer``).
    Under tensor parallelism assembled from the model group: each of its
    ranks calls this."""
    layout = state.layout
    whole = (lambda d: d) if layout is None else layout.whole
    optimizer = state.optimizer.state_dict()
    return {"net": whole(state.net.state_dict()), "ema": None if state.ema is None else whole(state.ema.params),
            "optimizer": optimizer if layout is None else _optimizer_tensors(state, optimizer, whole)}


def ema_state_dict(state: TrainState, whole: Optional[dict] = None) -> dict:
    """The net's whole ``state_dict`` with the EMA's parameters in place of
    its own (from ``whole``, :func:`whole_state`'s, where given)."""
    whole = whole or whole_state(state)
    return {k: whole["ema"].get(k, v) for k, v in whole["net"].items()}


def save_params(models_dir: str, state_dict: dict, label: str) -> str:
    os.makedirs(models_dir, exist_ok=True)
    path = os.path.join(models_dir, f"{label}.pth")
    torch.save(_cpu(state_dict), path)
    return path


def resolve_params_path(path: str) -> str:
    """``path``, or ``path + ".pth"`` where ``path`` names no file and no
    ``.pth``, but that file exists: a YAML may spell a save point
    ``{iter}_G`` (the JAX package's own name for it, an orbax directory),
    where the port writes ``{iter}_G.pth``.  Raises FileNotFoundError,
    naming the path, where neither exists."""
    if os.path.exists(path):
        return path
    if not path.endswith(".pth") and os.path.exists(path + ".pth"):
        return path + ".pth"
    raise FileNotFoundError(f"no checkpoint at {path}" + ("" if path.endswith(".pth") else f" nor {path}.pth"))


def load_params(path: str) -> dict:
    """A ``state_dict`` from a ``.pth`` on the host (``path`` through
    :func:`resolve_params_path`); a ``module.`` prefix (a reference net
    saved from DataParallel) is dropped, as the reference's
    ``load_network`` does."""
    sd = torch.load(resolve_params_path(path), map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def save_training_state(training_state_dir: str, state: TrainState, epoch: int, iter_step: int,
                        generator: torch.Generator, extra: Optional[dict] = None,
                        whole: Optional[dict] = None) -> str:
    """Write ``{iter}.state``, its tensors whole (``whole``, else
    :func:`whole_state`'s)."""
    whole = whole or whole_state(state)
    os.makedirs(training_state_dir, exist_ok=True)
    path = os.path.join(training_state_dir, f"{iter_step}.state")
    torch.save({
        "step": state.step, "epoch": epoch, "iter": iter_step,
        "optimizer": whole["optimizer"],
        "ema": None if state.ema is None else {"step": state.ema.step, "params": _cpu(whole["ema"])},
        "generator": generator.get_state(),
        "extra": extra or {},
    }, path)
    return path


def load_training_state(path: str, state: TrainState, generator: torch.Generator) -> Tuple[int, int, dict]:
    """Restore ``state`` (step, optimizer, EMA) and ``generator`` in place
    from ``{iter}.state``; the net's own weights come from ``{iter}_G.pth``.
    A split net's state keeps this rank's slices.  Returns ``(epoch, iter,
    extra)``."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    layout = state.layout
    state.step = int(ck["step"])
    optimizer = ck["optimizer"]
    state.optimizer.load_state_dict(optimizer if layout is None else _optimizer_tensors(state, optimizer, layout.shard))
    device = next(state.net.parameters()).device
    if ck["ema"] is not None:
        params = ck["ema"]["params"] if layout is None else layout.shard(ck["ema"]["params"])
        state.ema = EMA({k: v.to(device) for k, v in params.items()}, int(ck["ema"]["step"]))
    generator.set_state(ck["generator"])
    return int(ck["epoch"]), int(ck["iter"]), ck["extra"]


def save_checkpoint(opt_path: dict, state: TrainState, epoch: int, iter_step: int,
                    generator: torch.Generator, extra: Optional[dict] = None) -> None:
    """Full save point (ref train.py:305-309): weights, EMA, trainer state;
    written by rank 0 (its model group assembling the whole tensors with it)
    while the other ranks wait at a barrier."""
    if dist.data_rank() == 0:
        whole = whole_state(state)
        if dist.process_is_primary():
            save_params(opt_path["models"], whole["net"], f"{iter_step}_G")
            if state.ema is not None:
                save_params(opt_path["models"], ema_state_dict(state, whole), "lastest_EMA")
            save_training_state(opt_path["training_state"], state, epoch, iter_step, generator, extra, whole)
    dist.barrier()
