"""Multi-process dry run of the data- and tensor-parallel train step:

    python -m image_restoration_sde_tpu_torch.dryrun [N] [--device cuda|cpu]

Counterpart of ``__graft_entry__.dryrun_multichip``: :func:`dryrun_multichip`
starts N processes that join one process group and lay out as a mesh of N
/ M data rows by M model ranks (``parallel.mesh``; M = 2 where N is even,
as the JAX dry run takes it).  On the card they are NCCL ranks, one a card,
where there are N cards, else gloo ranks sharing the card; on the CPU,
which the caller asks for (``device="cpu"``), gloo ranks there.  Each takes one full IR-SDE train step
(ConditionalUNet nf 16, depth 2, T 8, 16 px, Adam and EMA) on its data
row's block of a global batch of 2N rows, drawing the global batch's
timesteps and noise: the net split over the model group (the time MLP,
the ResBlocks' scale/shift MLPs and the convolutions at least 64 channels
wide), DDP over the data group.

The JAX dry run's checks: (a) each data row holds batch / rows of the
global batch; (b) with M > 1 some parameters are split over the model
axis; (c) after the step they still are (the shards and the optimizer's
moments keep their shapes).  The port's own: the ranks' loss, the global
batch's, equals this process's one-process step at that batch; every
rank's assembled gradients and updated parameters equal the others', and
lie near the one-process step's; every rank launches the one-process
step's kernels (on the card: K1, K2a, K2b at full width on each rank).
TF32 is off on the card, so both sides compute in float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .models import ConditionalUNet, init_params_
from .parallel import dist
from .parallel.mesh import make_mesh
from .sde import IRSDE, rng
from .training import build_from_options, build_lr_schedule, create_train_state, make_train_step
from .training.trainer import data_parallel, tensor_parallel

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


def train_step(device: torch.device, global_batch: int, state_dict=None, model_parallel: int = 1) -> dict:
    """One train step at ``global_batch``: in one process, or this rank's
    rows of it inside a process group laid out with ``model_parallel``
    model ranks; the net seeded with flax's initialisers, or
    ``state_dict``.  Returns the loss (the global batch's), the gradients
    the optimizer stepped on (under DDP the data rows' mean), the updated
    parameters and the EMA's, all whole and on the host, the rows this
    rank held, the names of the parameters split over the model axis and
    whether their shards (and Adam's moments) kept their shapes through
    the step, and the kernel launches of the step."""
    from .ops import KERNELS

    if device.type == "cuda":  # float32 on both sides of the comparison, as on the CPU
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    net = init_params_(ConditionalUNet(in_nc=3, out_nc=3, nf=NF, depth=DEPTH), torch.Generator().manual_seed(0))
    if state_dict is not None:
        net.load_state_dict(state_dict)
    net = net.to(device).train()
    state = create_train_state(net, build_from_options(TRAIN_OPT, net.parameters(), build_lr_schedule(TRAIN_OPT)))
    if dist.is_initialized():
        mesh = make_mesh(model_parallel)
        if model_parallel > 1:
            tensor_parallel(state, mesh)
        data_parallel(state)
    split = {} if state.layout is None else {k: p.shape for k, p in net.named_parameters() if k in state.layout.splits}
    lq, gt = make_batch(global_batch)
    rows = dist.rows(global_batch)
    before = {k.symbol: k.launches for k in KERNELS}
    # eager in one process too: the ranks' steps are (their collectives are not captured)
    state, metrics = make_train_step(make_sde(device), capture=False)(state, lq[rows].to(device),
                                                                      gt[rows].to(device), step_generator(device))
    launches = {k.symbol: k.launches - before[k.symbol] for k in KERNELS}
    moments = state.optimizer.inner.state
    kept = all(p.shape == split[k] and all(v.shape == p.shape for v in moments[p].values() if v.dim())
               for k, p in net.named_parameters() if k in split)
    whole = (lambda d: d) if state.layout is None else state.layout.whole
    out = {"loss": float(metrics["loss"]),
           "grads": whole({k: v.grad.detach() for k, v in net.named_parameters()}),
           "params": whole({k: v.detach() for k, v in net.named_parameters()}),
           "ema": whole(state.ema.params),
           "rows": rows.stop - rows.start, "split": sorted(split), "layout_kept": kept, "launches": launches}
    for part in ("grads", "params", "ema"):
        out[part] = {k: v.cpu() for k, v in out[part].items()}
    return out


def grad_rel(got: dict, want: dict) -> float:
    """The largest of max|got - want| / max|want| over the tensors (a tensor
    whose gradient is zero throughout: max|got|)."""
    return max(((g - want[k]).abs().max() / want[k].abs().max()).item() if want[k].abs().max() > 0
               else g.abs().max().item() for k, g in got.items())


def dryrun_multichip(n: int, state_dict=None, model_parallel: Optional[int] = None, device: str = "cuda") -> dict:
    """Run the dry run over ``n`` processes (the net seeded, or
    ``state_dict``), ``model_parallel`` model ranks a row (2 where ``n`` is
    even), on ``device`` ("cuda", the card, by default: it raises where
    there is none; or "cpu"); raises where a rank fails or disagrees.
    Returns rank 0's step."""
    tp = model_parallel or (2 if n % 2 == 0 else 1)
    if device not in ("cuda", "cpu"):
        raise ValueError(f"dryrun_multichip: device {device!r}; 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu' to run on the CPU")
    backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= n else "gloo"
    batch, dp = 2 * n, n // tp
    one = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    want = train_step(one, batch, state_dict)
    ranks = dist.spawn(train_step, n, batch, state_dict, tp, device=device, backend=backend)
    got = ranks[0]
    lr = TRAIN_OPT["lr_G"]
    for r, other in enumerate(ranks):
        differ = [f"{part} {k} by {(v - got[part][k]).abs().max().item():.3g}" for part in ("grads", "params")
                  for k, v in other[part].items() if not torch.equal(v, got[part][k])]
        if other["loss"] != got["loss"] or differ:
            raise RuntimeError(f"dryrun_multichip: rank {r} differs from rank 0: loss {other['loss']!r} against "
                               f"{got['loss']!r}; {len(differ)} tensors differ ({', '.join(differ[:4])})")
        if other["launches"] != want["launches"]:
            raise RuntimeError(f"dryrun_multichip: rank {r} launched {other['launches']}, one process "
                               f"{want['launches']}")
        if other["rows"] != batch // dp:
            raise RuntimeError(f"dryrun_multichip: rank {r} held {other['rows']} rows of {batch} over {dp} data rows")
        if tp > 1 and not (other["split"] and other["layout_kept"]):
            raise RuntimeError(f"dryrun_multichip: rank {r}: {len(other['split'])} parameters split over the model "
                               f"axis, their layout kept through the step: {other['layout_kept']}")
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
    print(f"dryrun_multichip OK: world {n} ({backend}, {device}), batch {batch} ({batch // dp} a process), "
          f"loss {got['loss']:.8f} (one process {want['loss']:.8f}), gradients within {dgrad:.3g} of max|grad| of "
          f"one process's, parameters within {dparam:.3g} of one process's, mesh {{'data': {dp}, 'model': {tp}}}, "
          f"tp {tp}: {len(got['split'])} parameters split over the model axis", flush=True)
    return got


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="multi-process dry run of the data- and tensor-parallel train step")
    parser.add_argument("n", nargs="?", type=int, default=None, help="processes (default: the cards, at least 2)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    dryrun_multichip(args.n or max(2, torch.cuda.device_count()), device=args.device)
