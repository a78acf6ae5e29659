"""The train step as one captured device program per step signature.

Counterpart of the JAX package's compiled train step: each task jits its
step with the train state donated (``runners.py``), so the forward, the
backward, the optax update (``optax.MultiSteps`` included) and the EMA run
as one XLA program a call.  Here a step's device work (the forward, the
backward and the optimizer's update) is recorded once per step signature
into a CUDA graph and replayed (:class:`StepGraphs`, on the parts of
``sde/captured.py``): the host enqueues one graph launch a step instead of
every kernel of the forward, the backward and the update.

A step signature is the shapes and dtypes of the step's inputs (the batch,
the draws, a bokeh step's lens values), the position in a ``grad_accum``
cycle (each position divides by its own count), the task's own key
(``remat`` among it) and the TF32 switches (``sde/captured.py``).  What a
graph cannot hold stays on the host, around each replay and in the eager
step's order:

- the draws: the step's timesteps and noise come from the run's generator
  into the graph's static inputs before the replay (the SDEs'
  ``draw_states``; the graph composes the noisy states,
  ``compose_states``), so the generator ends where the eager step leaves it;
- the learning rate: written into the tensor the update reads
  (``ScheduledOptimizer.write_lr``) before the replay;
- the counts: the optimizer's ``updates`` and ``mini_step``
  (``ScheduledOptimizer.advance``) and ``state.step`` after it;
- the EMA: its decay is a host function of its count and it blends on one
  call in ten, so it runs eagerly after the replay, as the eager step runs
  it (``trainer``).

A signature's first call warms the step up on a side stream (every
library handle, plan and lazily made tensor the capture needs: the
optimizer's moments, the accumulated gradients, K3's pointer table; the
launches count in each kernel's ``warmups``), then restores what the
warm-up wrote, since a capture runs nothing and the step must not advance
twice: the parameters, the optimizer's state and the accumulated gradients
from host copies (host memory: the card holds the step's peak already;
state the warm-up made anew is zeroed: what the eager step makes at its
first update), and the gradients the step left.  Then it captures;
``torch.cuda.graph`` first frees what the warm-up left cached in the
default pool (``empty_cache``), so the graph's pool does not double the
peak.  Every call copies the batch and
draws into the static inputs, replays, points each parameter's ``grad`` at
the graph's gradient (as the eager step leaves them) and clones the
metrics out.

A graph reads every tensor by address.  The parameters, the optimizer's
state and a latent task's frozen compressor are updated in place, so a
graph stays valid across steps; :meth:`StepGraphs.sync` drops the graphs
where any of them is no longer the tensor it was captured on (a replaced
parameter, a loaded optimizer state).  A capture or replay that fails
raises; nothing falls back to the eager step.  A capture counts no launch,
a replay its recorded nodes (``kernels.Recording``).
"""

from __future__ import annotations

from typing import Callable, Hashable, Sequence

import torch

from ..sampling import captures
from ..sde.captured import CAPACITY, ChainGraphs, _clone


def step_graphs(capture) -> "StepGraphs | None":
    """A step maker's ``capture`` argument as its graph cache: True, a new
    :class:`StepGraphs` (steps on the card replay); False, None (every step
    eager); a :class:`StepGraphs`, itself (every step through it, on any
    device: a stand-in backend runs the capture flow on the CPU)."""
    if isinstance(capture, StepGraphs):
        return capture
    return StepGraphs() if capture else None


def replays(graphs, state, x: torch.Tensor) -> bool:
    """Whether a step of ``state`` on ``x`` replays a graph: where a
    sampler's chain would (``sampling.captures``), in one process (a data-
    or tensor-parallel step's collectives stay eager)."""
    return state.ddp is None and state.layout is None and captures(graphs, x)


def _written(state) -> list:
    """The tensors a step writes in place: the trained net's parameters and
    buffers and the optimizer's state."""
    return [*state.net.parameters(), *state.net.buffers(), *state.optimizer.state_tensors()]


class _Saved:
    """Host copies of what a warm-up of ``state``'s step writes, to put back
    after it (:meth:`restore`)."""

    def __init__(self, state):
        opt = state.optimizer
        self.state = state
        self.grads = [p.grad for p in opt.params]
        self.net = [t.detach().to("cpu", copy=True) for t in (*state.net.parameters(), *state.net.buffers())]
        self.inner = {p: {k: v.to("cpu", copy=True) if torch.is_tensor(v) else v for k, v in st.items()}
                      for p, st in opt.inner.state.items()}
        self.acc = None if opt.acc is None else [a.to("cpu", copy=True) for a in opt.acc]

    @torch.no_grad()
    def restore(self) -> None:
        state, opt = self.state, self.state.optimizer
        for t, saved in zip((*state.net.parameters(), *state.net.buffers()), self.net):
            t.copy_(saved)
        for p, st in opt.inner.state.items():
            saved = self.inner.get(p)
            for k, v in st.items():
                if saved:
                    if torch.is_tensor(v):
                        v.copy_(saved[k])
                    else:
                        st[k] = saved[k]
                elif torch.is_tensor(v):  # made by the warm-up: as the eager step makes it
                    v.zero_()
        for i, a in enumerate(opt.acc or ()):
            if self.acc is None:  # made by the warm-up
                a.zero_()
            else:
                a.copy_(self.acc[i])
        for p, g in zip(opt.params, self.grads):
            p.grad = g


class StepGraphs(ChainGraphs):
    """One train step's captured graphs by step signature (the last
    ``capacity`` kept), on :class:`~..sde.captured.ChainGraphs`' cache,
    backend and accounting; ``backend``: ``CudaGraphs`` or a stand-in (the
    CPU tests')."""

    def __init__(self, capacity: int = CAPACITY, backend=None):
        super().__init__(capacity, backend)
        self._addresses = None

    def sync(self, state, also: Sequence[torch.nn.Module] = ()) -> None:
        """Drop every graph where a tensor it reads by address (``state``'s
        parameters and optimizer state, ``also``'s parameters and buffers)
        is no longer the one it was captured on."""
        addresses = self._read(state, also)
        if self._addresses is not None and addresses != self._addresses:
            self.clear()
        self._addresses = addresses

    @staticmethod
    def _read(state, also) -> tuple:
        tensors = _written(state) + [t for m in also for t in (*m.parameters(), *m.buffers())]
        return tuple(t.data_ptr() for t in tensors)

    def step(self, state, key: Hashable, loss_fn: Callable, inputs: Sequence[torch.Tensor],
             also: Sequence[torch.nn.Module] = ()) -> dict:
        """One step of ``state`` replayed: ``loss_fn(*inputs)`` (the metrics
        by name, ``loss`` the one differentiated), its backward and the
        optimizer's update, from the graph of ``key`` and the signature,
        captured first at the signature's first call; ``also``: modules the
        step reads and does not train.  Writes the learning rate before and
        counts the optimizer's call after; returns the metrics, cloned.
        The caller runs the EMA and counts the step."""
        opt = state.optimizer
        self.sync(state, also)
        position = opt.mini_step
        names = []

        def body(*statics):
            metrics = loss_fn(*statics)
            opt.zero_grad()
            metrics["loss"].backward()
            opt.apply(position)
            names[:] = list(metrics)
            return tuple(v.detach() for v in metrics.values())

        def warmup(*statics):
            saved = _Saved(state)
            try:
                body(*statics)
            finally:
                saved.restore()

        signature = tuple((tuple(x.shape), x.dtype) for x in inputs)
        opt.write_lr()
        with self._lock:
            entry = self.prepare((key, signature, position), body, inputs, warmup)
            if not hasattr(entry, "grads"):  # captured by this call
                entry.grads, entry.names = [p.grad for p in opt.params], tuple(names)
                self._addresses = self._read(state, also)  # the state the warm-up made
            for static, x in zip(entry.inputs, inputs):
                static.copy_(x)
            entry.graph.replay()
            entry.recording.replayed()
            for p, g in zip(opt.params, entry.grads):
                p.grad = g
            out = _clone(entry.output)
        opt.advance()
        return dict(zip(entry.names, out))
