"""What every cell's run shares, and the choice of its parts by name.

A cell's run is its traffic mix's loop (``loops/<loop>.py``, named by the
mix's ``loop``) driving its configuration's system (``systems/<system>.py``,
named by the configuration's ``system``).  The system builds the port's
entry point from the benchmark's weights and says how the plain reference
(``reference/<config>.py``) computes the same call; the loop warms up the
cell's own shapes, runs the measured window, runs a bounded slice for the
profiler and, after the window, compares what the window produced with the
reference.  A new family or a new loop is a new file, found by its name.

Every input, weight and draw comes from the run's seed
(``weights.derive``); the reference is handed the same ones.  The port is
imported by the systems and the loops, never by the reference.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch

from .reference.precision import Precision
from .weights import make_state_dict, shapes_of

PARTS = {"score": 0, "compressor": 1}  # which weights each network takes (weights.make_state_dict)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rel_gaps(program, reference) -> list:
    """Each row's ||program - reference|| / ||reference||."""
    p = torch.as_tensor(program).float().flatten(1)
    r = reference.float().flatten(1).to(p.device)
    return ((p - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)).tolist()


def on_meta(build):
    """``build()`` with its tensors on the meta device: nothing is drawn or
    allocated for weights the benchmark then loads."""
    with torch.device("meta"):
        return build()


def reference_precision(device) -> None:
    """float32 with TF32 off, as the reference computes."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def multiset_minus(a: list, b: list) -> list:
    left = Counter(a)
    left.subtract(Counter(b))
    return [k for k, n in left.items() for _ in range(n)]


def port_model(part: dict):
    """The port's network that a configuration's part names by ``which``,
    built with its ``setting``, computing in its ``compute_dtype``."""
    from image_restoration_sde_tpu_torch import models

    cls = getattr(models, part["which"], None)
    if cls is None:
        raise ValueError(f"the port has no network {part['which']!r}")
    dtype = {} if part["compute_dtype"] == "float32" else {"dtype": getattr(torch, part["compute_dtype"])}
    return cls(**part["setting"], **dtype)


class Run:
    """One run of a cell: its seed, device, weights and reference, and what
    the check compares (``kept``).  A loop (``loops/``) subclasses it."""

    def __init__(self, cell, seed: int, device, system, reference=None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.config, self.traffic, self.system = cell.config, cell.traffic, system
        self.ref_module = reference if reference is not None else cell.reference()
        self.graphs = []  # the port's ChainGraphs this run made
        self.kept = {}
        self.phases = {}  # set-up seconds by phase, for standard error

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.phases[name] = time.perf_counter() - t0

    def reference(self, device, prec: Precision = None, load: bool = True) -> dict:
        """The reference's networks and SDE, with the run's weights."""
        ref = self.ref_module.build(self.config, device, prec or Precision())
        if load:
            for role, net in self.networks(ref).items():
                net.load_state_dict(self.weights(role, net, device))
        return ref

    @staticmethod
    def networks(ref: dict) -> dict:
        return {k: v for k, v in ref.items() if isinstance(v, torch.nn.Module)}

    def weights(self, role: str, module: torch.nn.Module, device=None) -> dict:
        return make_state_dict(shapes_of(module), self.seed, PARTS[role], device or self.device)

    def port_net(self, role: str, part: dict) -> torch.nn.Module:
        """The port's network for the configuration's ``part``, made on the
        meta device and given the run's weights on the card, in eval mode."""
        ref = on_meta(lambda: self.reference("meta", load=False))[role]
        net = on_meta(lambda: port_model(part)).to_empty(device=self.device)
        net.load_state_dict(self.weights(role, ref))
        return net.eval()

    def graph_entries(self) -> list:
        return [entry for g in self.graphs if g is not None for _, entry in g.entries()]

    def flops_and_sites(self):
        """The work of the window's unit (a call) by the reference: (FLOP by
        ``FlopCounterMode``, the port-kernel sites), or None."""
        return None

    def free(self) -> None:
        """Drop the program's state before the reference runs."""


def make(cell, seed: int, device, reference=None) -> Run:
    """The run of ``cell``: its mix's loop driving its configuration's system."""
    return cell.loop().Loop(cell, seed, device, cell.system().System(), reference)
