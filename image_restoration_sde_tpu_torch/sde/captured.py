"""The sampling chain as one captured device program per call signature.

Counterpart of the JAX package's compiled chain: ``sde/samplers.py`` makes
the whole reverse diffusion one ``lax.scan`` and ``sampling.py`` jits it
once per shape bucket ("each bucket compiles once").  Here a chain closure
(the samplers' Python loop over the network) is recorded once per call
signature into a CUDA graph and replayed: the host enqueues one graph
launch a call instead of every kernel of every step.

:class:`ChainGraphs` is one sampler's cache of captured chains, keyed by
its signature (shape and dtype, mode and steps, generator layout, chunk).
A signature's first call warms the chain up on a side stream (a chain of
one step by default: every library handle, plan cache, lazily made table
and kernel attribute the capture will need; those launches count in each
kernel's ``warmups``), then captures it once into a memory pool that the
sampler's graphs share.  Every call copies its inputs into the graph's
static inputs, replays, and clones the output out (graphs that share a pool
overwrite each other's memory).  The chain must read only its static
inputs: noise reaches it through a buffer the caller fills before each
replay (``samplers.draw_noise``), which keeps the caller's generators
exactly where the eager chain leaves them.  The cache keeps the last
CAPACITY signatures, as ``tiling.py``'s ``lru_cache(16)`` does in the JAX
package; evicting one drops its graph and every tensor it holds.

A graph keeps the library choices of its capture, so the key also holds
the TF32 switches (``torch.backends``) in force at the call: a call under
other settings captures its own graph, as the eager chain would choose
anew.  A capture or replay that fails raises; nothing here falls back to
the eager chain.  The kernels' launch counts stay exact: a capture counts
nothing, each replay adds the graph's recorded nodes
(``kernels.Recording``).  Captures are serialised process-wide (worker
threads of ``exporting.DataParallelSampler`` and ``serve.MicroBatcher``
capture too) and use ``capture_error_mode="thread_local"``, so another
thread's work on the card goes on during a capture.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Hashable, Optional, Sequence

import torch

from .. import kernels

CAPACITY = 16
_CAPTURE_LOCK = threading.Lock()


def _library_settings() -> tuple:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def generator_layout(gen) -> str:
    """The generator part of a call signature: none, one, or one per sample."""
    if gen is None:
        return "none"
    return "per_sample" if isinstance(gen, (list, tuple)) else "one"


_STREAMS = {}  # (device, "warm" or "capture") -> the one stream of that role


def _stream(device, role: str):
    """The process's one warm-up or capture stream on ``device``: the
    libraries keep a workspace for every stream they run on (cuBLAS one a
    handle and stream) for the life of the process, so every capture takes
    the same two."""
    if (device, role) not in _STREAMS:
        _STREAMS[device, role] = torch.cuda.Stream(device)
    return _STREAMS[device, role]


class CudaGraphs:
    """How :class:`ChainGraphs` warms up and captures on the card."""

    def pool(self, device):
        with torch.cuda.device(device):
            return torch.cuda.graph_pool_handle()

    def warm(self, device, fn: Callable) -> None:
        current = torch.cuda.current_stream(device)
        side = _stream(device, "warm")
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)

    def capture(self, device, pool, fn: Callable):
        """``(graph, output)`` of ``fn`` captured on ``device``'s capture stream."""
        stream = _stream(device, "capture")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool, stream=stream,
                                                         capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    def pool_bytes(self, device, pool) -> int:
        """Bytes the allocator holds in ``pool``'s segments on ``device``."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg.get("device") == device.index and tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class Captured:
    """One captured chain: ``graph``, its static ``inputs`` and ``output``,
    ``recording`` (its kernels' nodes, the tensors it owns), and the host
    seconds of its warm-up and its capture."""

    def __init__(self, graph, inputs: tuple, output, recording: kernels.Recording, warm_s: float, capture_s: float):
        self.graph, self.inputs, self.output, self.recording = graph, inputs, output, recording
        self.warm_s, self.capture_s = warm_s, capture_s

    def input_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.inputs)


def _clone(out):
    if isinstance(out, (list, tuple)):
        return type(out)(_clone(t) for t in out)
    return out.clone()


class ChainGraphs:
    """One sampler's captured chains by call signature, the last
    ``capacity`` kept.  ``graphs(key, chain, inputs)`` returns
    ``chain(*inputs)`` replayed from the graph of ``key``, capturing it
    first at the key's first call; ``warmup(*inputs)`` (default ``chain``)
    is what runs before the capture.  ``backend``: :class:`CudaGraphs`, or
    a stand-in with its methods (the CPU tests')."""

    def __init__(self, capacity: int = CAPACITY, backend=None):
        self.capacity = int(capacity)
        self.backend = backend if backend is not None else CudaGraphs()
        self._entries: "OrderedDict[Hashable, Captured]" = OrderedDict()
        self._pools = {}
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list:
        """``(key, Captured)`` of every graph held, oldest first."""
        with self._lock:
            return [(key, entry) for (key, _), entry in self._entries.items()]

    def clear(self) -> None:
        """Drop every graph, the tensors it holds and the pools."""
        with self._lock:
            self._entries.clear()
            self._pools.clear()

    def prepare(self, key: Hashable, chain: Callable, inputs: Sequence[torch.Tensor],
                warmup: Optional[Callable] = None) -> Captured:
        """The graph of ``key``, captured now on ``inputs`` if it is not held."""
        key = (key, _library_settings())
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = self._capture(chain, tuple(inputs), warmup)
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
            else:
                self._entries.move_to_end(key)
            return entry

    def __call__(self, key: Hashable, chain: Callable, inputs: Sequence[torch.Tensor],
                 warmup: Optional[Callable] = None):
        with self._lock:
            entry = self.prepare(key, chain, inputs, warmup)
            for static, x in zip(entry.inputs, inputs):
                static.copy_(x)
            entry.graph.replay()
            entry.recording.replayed()
            return _clone(entry.output)

    def pool_bytes(self) -> int:
        """Bytes held in this sampler's graph pools (on the card)."""
        with self._lock:
            return sum(self.backend.pool_bytes(device, pool) for device, pool in self._pools.items())

    def _capture(self, chain, inputs, warmup) -> Captured:
        device = inputs[0].device
        statics = tuple(x.clone() for x in inputs)  # outside the pool: written before each replay
        if device not in self._pools:
            self._pools[device] = self.backend.pool(device)
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            with kernels.warming_up():
                self.backend.warm(device, lambda: (warmup or chain)(*statics))
            t1 = time.perf_counter()
            with kernels.recording() as rec:
                graph, out = self.backend.capture(device, self._pools[device], lambda: chain(*statics))
            t2 = time.perf_counter()
        return Captured(graph, statics, out, rec, t1 - t0, t2 - t1)
