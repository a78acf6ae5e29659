"""Multi-process dry run of the data-parallel train step:

    python -m image_restoration_sde_tpu_torch.dryrun [N]

Counterpart of ``__graft_entry__.dryrun_multichip``: :func:`dryrun_multichip`
starts N processes that join one process group (NCCL ranks, one a card,
where there are N cards; gloo ranks on the CPU otherwise), and each takes
one full IR-SDE train step (ConditionalUNet nf 16, depth 2, T 8, 16 px,
Adam and EMA) through DDP on its rows of a global batch of 2N, drawing the
global batch's timesteps and noise.  The ranks' loss, the global batch's,
must equal this process's one-process step at that batch; every rank's
averaged gradient and updated parameters must equal the others', and lie
near the one-process step's.
Tensor parallelism is not ported (``tp 1``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .models import ConditionalUNet, init_params_
from .parallel import dist
from .sde import IRSDE, rng
from .training import build_from_options, build_lr_schedule, create_train_state, make_train_step
from .training.trainer import data_parallel

TRAIN_OPT = {"optimizer": "Adam", "lr_G": 1e-4, "beta1": 0.9, "beta2": 0.99, "lr_scheme": "MultiStepLR",
             "lr_steps": []}
SIZE, NF, DEPTH, T = 16, 16, 2, 8
# the ranks' mean gradient against the one-process step's: each tensor
# within this share of its max|grad| (float32 sums over the batch in
# another order: two halves, then their mean)
GRAD_REL = 2e-4


def make_sde(device) -> IRSDE:
    return IRSDE.create(max_sigma=10.0, T=T, schedule="cosine", eps=0.005, device=device)


def make_batch(global_batch: int) -> tuple:
    """The global batch ``(lq, gt)``, NHWC float32 on the host, from the
    seed."""
    data = torch.Generator().manual_seed(1)
    lq = torch.rand((global_batch, SIZE, SIZE, 3), generator=data)
    return lq, (lq + 0.2 * torch.rand(lq.shape, generator=data)).clamp(0, 1)


def step_generator(device) -> torch.Generator:
    """The generator the step draws its timesteps and noise from."""
    return rng.generator(2, device)


def train_step(device: torch.device, global_batch: int, state_dict=None) -> dict:
    """One train step at ``global_batch``: in one process, or this rank's
    rows of it inside a process group; the net seeded with flax's
    initialisers, or ``state_dict``.  Returns the loss (the global
    batch's), the gradients the optimizer stepped on (under DDP the ranks'
    mean), the updated parameters and the EMA's, on the host."""
    net = init_params_(ConditionalUNet(in_nc=3, out_nc=3, nf=NF, depth=DEPTH), torch.Generator().manual_seed(0))
    if state_dict is not None:
        net.load_state_dict(state_dict)
    net = net.to(device).train()
    state = create_train_state(net, build_from_options(TRAIN_OPT, net.parameters(), build_lr_schedule(TRAIN_OPT)))
    if dist.is_initialized():
        data_parallel(state)
    lq, gt = make_batch(global_batch)
    rows = dist.rows(global_batch)
    state, metrics = make_train_step(make_sde(device))(state, lq[rows].to(device), gt[rows].to(device),
                                                       step_generator(device))
    return {"loss": float(metrics["loss"]),
            "grads": {k: v.grad.detach().cpu() for k, v in net.named_parameters()},
            "params": {k: v.detach().cpu() for k, v in net.named_parameters()},
            "ema": {k: v.cpu() for k, v in state.ema.params.items()}}


def grad_rel(got: dict, want: dict) -> float:
    """The largest of max|got - want| / max|want| over the tensors (a tensor
    whose gradient is zero throughout: max|got|)."""
    return max(((g - want[k]).abs().max() / want[k].abs().max()).item() if want[k].abs().max() > 0
               else g.abs().max().item() for k, g in got.items())


def dryrun_multichip(n: int, state_dict=None) -> dict:
    """Run the dry run over ``n`` processes (the net seeded, or
    ``state_dict``); raises where a rank fails or disagrees.  Returns rank
    0's step."""
    on_cards = torch.cuda.is_available() and torch.cuda.device_count() >= n
    device = "cuda" if on_cards else "cpu"
    batch = 2 * n
    want = train_step(torch.device("cuda", 0) if on_cards else torch.device("cpu"), batch, state_dict)
    ranks = dist.spawn(train_step, n, batch, state_dict, device=device)
    got = ranks[0]
    lr = TRAIN_OPT["lr_G"]
    for r, other in enumerate(ranks):
        if other["loss"] != got["loss"] or any(not torch.equal(v, got[part][k]) for part in ("grads", "params")
                                               for k, v in other[part].items()):
            raise RuntimeError(f"dryrun_multichip: rank {r} differs from rank 0")
    if not abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"]):
        raise RuntimeError(f"dryrun_multichip: loss {got['loss']!r} against {want['loss']!r} in one process")
    dgrad = grad_rel(got["grads"], want["grads"])
    if not dgrad <= GRAD_REL:
        raise RuntimeError(f"dryrun_multichip: gradients {dgrad:.3g} of max|grad| from the one-process step's "
                           f"(bound {GRAD_REL})")
    dparam = max((v - want["params"][k]).abs().max().item() for k, v in got["params"].items())
    if not dparam <= 2 * lr:
        raise RuntimeError(f"dryrun_multichip: parameters {dparam:.3g} from the one-process step's (2 lr {2 * lr})")
    if not np.isfinite(got["loss"]):
        raise RuntimeError(f"dryrun_multichip: loss {got['loss']}")
    print(f"dryrun_multichip OK: world {n} ({'nccl' if on_cards else 'gloo'}, {device}), batch {batch} "
          f"({batch // n} a process), loss {got['loss']:.8f} (one process {want['loss']:.8f}), gradients within "
          f"{dgrad:.3g} of max|grad| of one process's, parameters within "
          f"{dparam:.3g} of one process's, tp 1 (tensor parallelism not ported)", flush=True)
    return got


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else max(2, torch.cuda.device_count()))
