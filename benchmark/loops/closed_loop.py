"""A closed loop: one caller sends a batch of ``batch`` images of ``size``
(H, W), waits for its restored images and sends the next.

Parameters (``traffic/<mix>.json``): ``batch``, ``size``, ``mode`` (the
chain's step: ``sde`` or ``posterior``), ``inputs`` (distinct input
batches, sent in turn), ``check_from`` (the window's first calls the check
may draw from), ``check_calls`` and ``check_images`` (how many calls, and
images of each, the check compares, drawn from the seed) and
``trace_calls`` (whole calls in the traced slice).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.cells import Run, multiset_minus, on_meta, reference_precision, rel_gaps, sync
from benchmark.weights import derive, generator, uniform_images


def draws(seed: int, shape: tuple, n: int, device, rows: list) -> torch.Tensor:
    """``n`` N(0, 1) tensors of ``shape`` from one generator, in turn (the
    chain's draws as the port makes them from one generator), each cut to
    the batch's ``rows``."""
    g = generator(seed, device)
    return torch.stack([torch.randn(shape, generator=g, device=device)[rows] for _ in range(n)])


class Loop(Run):
    def setup(self, first_call: bool = True) -> None:
        t = self.traffic
        self.batch, (self.H, self.W) = int(t["batch"]), t["size"]
        self.mode = t["mode"]
        with self.phase("weights_and_inputs"):
            self.inputs = [uniform_images(self.seed, i, (self.batch, self.H, self.W, 3), self.device)
                           for i in range(int(t["inputs"]))]
            self.sampler = self.system.build(self)
        with self.phase("capture"):
            self.sampler.prepare(self.inputs[0], generator(0, self.device))
        if first_call:
            with self.phase("first_call"):
                self.call(-1)  # the graph's first replay, outside the window
        self.rows = {}

    def call(self, i: int):
        return self.sampler(self.inputs[i % len(self.inputs)], generator(derive(self.seed, "noise", i), self.device))

    def window(self, seconds: float) -> dict:
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            out = self.call(n)
            sync(self.device)
            if n < int(self.traffic["check_from"]):
                self.kept[n] = out
            n += 1
        t1 = time.perf_counter()
        self.choose(n)
        return {"kind": "sample", "units": n, "items": n * self.batch, "start": t0, "end": t1,
                "attempted": n * self.batch, "failed": 0}

    def choose(self, calls: int) -> None:
        """The images the check compares: ``check_images`` of each of
        ``check_calls`` calls among the window's first ``check_from``, drawn
        from the seed; the kept outputs are cut to them."""
        t = self.traffic
        pool = min(calls, int(t["check_from"]))
        rng = np.random.default_rng(derive(self.seed, "sample"))
        picked = rng.choice(pool, size=min(pool, int(t["check_calls"])), replace=False).tolist()
        self.rows = {i: sorted(rng.choice(self.batch, size=min(self.batch, int(t["check_images"])),
                                          replace=False).tolist()) for i in picked}
        self.kept = {i: self.kept[i][self.rows[i]] for i in self.rows if i in self.kept}

    def traced(self, record) -> dict:
        """``trace_calls`` whole calls, numbered after any window's."""
        calls = int(self.traffic["trace_calls"])
        for i in range(calls):
            with record("call"):
                self.call(10**6 + i)
            with record("sync"):
                sync(self.device)
        return {"units": calls, "items": calls * self.batch}

    def free(self) -> None:
        self.sampler = None
        self.graphs = []

    def noise_shape(self, batch: int) -> tuple:
        return self.system.noise_shape(self, batch, self.H, self.W)

    def flops_and_sites(self):
        """One call's FLOP and kernel sites: the reference at zero and one
        step on the meta device, the step's part times T."""
        from torch.utils.flop_counter import FlopCounterMode

        ref = on_meta(lambda: self.reference("meta", load=False))
        ctxs = {net.ctx for net in self.networks(ref).values()}
        x = torch.zeros((self.batch, self.H, self.W, 3), device="meta")
        counts = []
        for steps in (0, 1):
            for c in ctxs:
                c.sites = []
            with FlopCounterMode(display=False) as counter, torch.no_grad():
                noise = torch.zeros((steps + 1, *self.noise_shape(self.batch)), device="meta")
                self.system.reference_call(ref, x, noise, self.mode, steps)
            counts.append((counter.get_total_flops(), [s for c in ctxs for s in c.sites]))
        (f0, s0), (f1, s1) = counts
        T = self.config["sde"]["T"]
        return f0 + (f1 - f0) * T, s0 + multiset_minus(s1, s0) * T

    def reference_outputs(self, ref) -> dict:
        """The reference's answers for the checked images of each checked
        call, on the call's own inputs and draws."""
        out = {}
        for i, rows in sorted(self.rows.items()):
            x = self.inputs[i % len(self.inputs)][rows]
            noise = draws(derive(self.seed, "noise", i), self.noise_shape(self.batch), self.config["sde"]["T"] + 1,
                          self.device, rows)
            with torch.no_grad():
                out[i] = self.system.reference_call(ref, x, noise, self.mode)
            del noise
        return out

    def check(self) -> list:
        """The worst checked image's relative L2 gap to the reference; a
        checked call missing reads ``inf``."""
        if not self.rows or any(i not in self.kept for i in self.rows):
            return [("worst_image_gap", math.inf)]
        reference_precision(self.device)
        ref = self.reference(self.device)
        worst = 0.0
        for i, r in self.reference_outputs(ref).items():
            worst = max([worst, *rel_gaps(self.kept[i], r)])
        return [("worst_image_gap", worst)]
