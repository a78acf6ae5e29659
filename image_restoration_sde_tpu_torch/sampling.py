"""High-level restoration sampling API (PyTorch).

Counterpart of ``image_restoration_sde_tpu/sampling.py``: start from the
noised LQ image (``noise_state``) and run the chosen reverse sampler; or,
for the denoising SDE, run the reverse ODE from the noisy image at the
timestep of its noise level.  Any image size runs as it is;
``pad_to_bucket`` / ``unpad`` reflect-pad to a bucket multiple and crop
back, as the JAX package does for its compiled shapes.

On the card a sampler runs each chunk's whole chain as one captured CUDA
graph per call signature (``sde/captured.py``), as the JAX package jits
its ``lax.scan`` chain once per shape: the first call of a signature warms
the chain up and captures it, every call replays it.  The noise is drawn
before the replay, from the caller's generators in the eager chain's order
(``samplers.draw_noise``), and the per-call parameter cast runs inside the
graph; so a replay gives the eager chain's output bit for bit and leaves
the generators where it does.  ``capture=False`` runs the eager chain on
the card; on the CPU the chain is always eager.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .sde import DenoisingSDE, IRSDE, samplers
from .sde.captured import ChainGraphs, CudaGraphs, generator_layout
from .sde.rng import GeneratorLike, is_generator_batch

SAMPLING_MODES = ("sde", "posterior", "ode")


def cast_f32_leaves(tensors: Mapping[str, torch.Tensor], dtype) -> dict:
    """Cast every float32 tensor of a parameter mapping to ``dtype``; other
    tensors pass through."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in tensors.items()}


def _sample_chunk(batch: int, chunk: Optional[int]) -> int:
    """Sub-batch size the sampler loops over.  None or <= 0: the whole batch.

    Otherwise the largest divisor of ``batch`` not above ``chunk``, unless
    that is below half of ``chunk`` (a batch coprime to it): then the whole
    batch."""
    if chunk is None or chunk <= 0:
        return batch
    want = chunk
    while chunk > 1 and batch % chunk:
        chunk -= 1
    if chunk < max(1, want // 2):
        return batch
    return min(chunk, batch)


def check_mode(mode: str) -> None:
    if mode not in SAMPLING_MODES:
        raise ValueError(f"sampling mode {mode!r}; options: {SAMPLING_MODES}")


def reverse(sde: IRSDE, noise_fn, noisy, mu, gen, mode: str, steps: Optional[int]):
    """The reverse chain of ``mode`` from ``noisy`` towards ``mu``."""
    if mode == "sde":
        return samplers.reverse_sde(sde, noise_fn, noisy, mu, gen, steps=steps)
    if mode == "posterior":
        return samplers.reverse_posterior(sde, noise_fn, noisy, mu, gen, steps=steps)
    return samplers.reverse_ode(sde, noise_fn, noisy, mu, steps=steps)


def cast_net_params(net: nn.Module, cast_params) -> dict:
    """``net``'s parameters and buffers by name, the float32 ones cast to
    ``cast_params``.  Parameters the net names in ``fused_param_names()``
    take the cast's values in float32 storage, as its fused levels read
    them."""
    params = cast_f32_leaves({**dict(net.named_parameters()), **dict(net.named_buffers())}, cast_params)
    for k in getattr(net, "fused_param_names", list)():
        params[k] = params[k].float()
    return params


def make_noise_fn(net: nn.Module, cast_params) -> Callable:
    """``net``, or ``net`` with its parameters and buffers cast to
    ``cast_params`` (cast once, here: :func:`cast_net_params`)."""
    if cast_params is None:
        return net
    params = cast_net_params(net, cast_params)

    def noise_fn(*args):
        return functional_call(net, params, args)

    return noise_fn


class CapturedNet:
    """The score net as a sampler's captured chains call it, and the guard
    of its graphs (``graphs``).  :meth:`sync` drops them where the net's (or
    ``also``'s) tensors are no longer the ones they were captured on (a
    graph reads parameters by address: values updated in place reach it,
    replaced tensors would not), and with ``cast_params`` makes the cast
    parameters' tensors (:func:`cast_net_params`) once, outside any graph.
    :meth:`fn`, called inside the chain, casts into those tensors (the
    per-call cast, recorded in the graph; their addresses stay, as the graph
    and K3's pointer table read them) and returns what the chain calls."""

    def __init__(self, net: nn.Module, cast_params, graphs: ChainGraphs, also: tuple = ()):
        self.net, self.cast_params, self.graphs, self.also = net, cast_params, graphs, also
        self._ptrs, self._params, self._pairs = None, None, []

    def sync(self) -> None:
        ptrs = tuple(t.data_ptr() for m in (self.net, *self.also) for t in (*m.parameters(), *m.buffers()))
        if ptrs == self._ptrs:
            return
        self.graphs.clear()
        self._ptrs = ptrs
        if self.cast_params is not None:
            sources = {**dict(self.net.named_parameters()), **dict(self.net.named_buffers())}
            fused = set(getattr(self.net, "fused_param_names", list)())
            self._params = cast_net_params(self.net, self.cast_params)
            self._pairs = [(v, sources[k], k in fused) for k, v in self._params.items() if v is not sources[k]]

    def fn(self) -> Callable:
        if self.cast_params is None:
            return self.net
        for dst, src, fused in self._pairs:
            dst.copy_(src.to(self.cast_params) if fused else src)
        return lambda *args: functional_call(self.net, self._params, args)


def capture_graphs(capture) -> Optional[ChainGraphs]:
    """A sampler's ``capture`` argument as its graph cache: True, a new
    :class:`ChainGraphs` (CUDA calls replay); False, None (every call
    eager); a :class:`ChainGraphs`, itself (every call through it, on any
    device: a stand-in backend runs the capture flow on the CPU)."""
    if isinstance(capture, ChainGraphs):
        return capture
    return ChainGraphs() if capture else None


def captures(graphs: Optional[ChainGraphs], x: torch.Tensor) -> bool:
    """Whether a call on ``x`` replays a captured chain."""
    return graphs is not None and (x.is_cuda or not isinstance(graphs.backend, CudaGraphs))


def chunked(lq: torch.Tensor, gen: GeneratorLike, chunk: Optional[int], cond=None) -> list:
    """``[lq_chunk, gen_chunk]`` (and ``cond_chunk`` where ``cond``, a
    tuple of per-sample tensors with the batch as their first axis, is
    given) of each sub-batch of :func:`_sample_chunk`'s size."""
    B = lq.shape[0]
    c = _sample_chunk(B, chunk)
    out = []
    for i in range(0, B, c):
        args = [lq[i : i + c], gen[i : i + c] if is_generator_batch(gen) else gen]
        if cond is not None:
            args.append(tuple(v[i : i + c] for v in cond))
        out.append(args)
    return out


def run_chunks(sample_one: Callable, lq: torch.Tensor, gen: GeneratorLike, chunk: Optional[int], cond=None):
    """``sample_one(lq_chunk, gen_chunk[, cond_chunk])`` over the batch's
    sub-batches (:func:`chunked`), concatenated."""
    outs = [sample_one(*args) for args in chunked(lq, gen, chunk, cond)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def make_restoration_sampler(
    sde: IRSDE,
    net: nn.Module,  # net(xt, cond, tvec) -> noise, NHWC
    mode: str = "posterior",
    steps: Optional[int] = None,
    chunk: Optional[int] = None,
    cast_params=None,
    capture=True,
) -> Callable:
    """Returns ``sample(lq, gen) -> restored`` (NHWC float32).

    ``gen`` is one ``torch.Generator`` for the batch, or one per sample (then
    sample i's noise depends only on generator i).  ``chunk`` splits the
    batch into sub-batches run one after the other; the default runs the
    whole batch at once.  ``cast_params`` runs the net with its float32
    parameters cast to that dtype, once per call.  ``capture`` (see
    :func:`capture_graphs`): on the card each chunk's chain is one graph a
    signature (shape, dtype, mode, steps, generator layout, chunk),
    ``sample.graphs``; ``sample.prepare(lq, gen)`` captures the graphs a
    call would replay, drawing nothing (nothing where the call is eager)."""
    check_mode(mode)
    T = sde.T if steps is None else steps
    graphs = capture_graphs(capture)
    captured = None if graphs is None else CapturedNet(net, cast_params, graphs)

    def chain(n):
        def run(x, noise):
            return samplers.reverse_from_noise(sde, captured.fn(), x, noise[: samplers.chain_draws(mode, n)], mode, n)

        return run

    def replay(x, g, noise=None):
        """The chunk ``x``'s chain from its graph (captured first at a new
        signature); ``noise`` None: prepare only."""
        key = (tuple(x.shape), x.dtype, mode, T, generator_layout(g), chunk)
        inputs = (x, x.new_zeros((samplers.chain_draws(mode, T), *x.shape)) if noise is None else noise)
        if noise is None:
            return graphs.prepare(key, chain(T), inputs, warmup=chain(1))
        return graphs(key, chain(T), inputs, warmup=chain(1))

    @torch.inference_mode()
    def sample(lq: torch.Tensor, gen: GeneratorLike) -> torch.Tensor:
        if captures(graphs, lq):
            captured.sync()
            return run_chunks(lambda x, g: replay(x, g, samplers.draw_noise(g, x, samplers.chain_draws(mode, T))),
                              lq, gen, chunk)
        noise_fn = make_noise_fn(net, cast_params)

        def sample_one(x, g):
            return reverse(sde, noise_fn, sde.noise_state(g, x), x, g, mode, steps)

        return run_chunks(sample_one, lq, gen, chunk)

    @torch.inference_mode()
    def prepare(lq: torch.Tensor, gen: GeneratorLike) -> None:
        if not captures(graphs, lq):
            return
        captured.sync()
        for x, g in chunked(lq, gen, chunk):
            replay(x, g)

    sample.graphs, sample.prepare = graphs, prepare
    return sample


def make_denoising_sampler(
    sde: DenoisingSDE,
    net: nn.Module,  # net(x, None, tvec) -> noise, NHWC
    sigma: float,
    cast_params=None,
    capture=True,
) -> Callable:
    """Returns ``sample(noisy) -> denoised`` (NHWC float32): the reverse ODE
    from ``noisy`` over ``t0`` steps, ``t0 = sde.get_optimal_timestep(sigma)``
    computed once, here.  Deterministic: no generator.  ``cast_params`` and
    ``capture`` as in :func:`make_restoration_sampler` (one graph a shape
    and dtype; ``sample.prepare(noisy)``)."""
    t0 = sde.get_optimal_timestep(sigma)
    graphs = capture_graphs(capture)
    captured = None if graphs is None else CapturedNet(net, cast_params, graphs)

    def chain(n):
        def run(x):
            fn = captured.fn()
            return samplers.dsde_reverse_ode(sde, lambda x_, tvec: fn(x_, None, tvec), x, steps=n)

        return run

    def key(x):
        return (tuple(x.shape), x.dtype, "ode", t0, "none", None)

    @torch.inference_mode()
    def sample(noisy: torch.Tensor) -> torch.Tensor:
        if captures(graphs, noisy):
            captured.sync()
            return graphs(key(noisy), chain(t0), (noisy,), warmup=chain(1))
        noise_fn = make_noise_fn(net, cast_params)
        return samplers.dsde_reverse_ode(sde, lambda x, tvec: noise_fn(x, None, tvec), noisy, steps=t0)

    @torch.inference_mode()
    def prepare(noisy: torch.Tensor) -> None:
        if not captures(graphs, noisy):
            return
        captured.sync()
        graphs.prepare(key(noisy), chain(t0), (noisy,), warmup=chain(1))

    sample.t0, sample.graphs, sample.prepare = t0, graphs, prepare
    return sample


def pad_to_bucket(img: np.ndarray, multiple: int = 64) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Reflect-pad NHWC (bottom/right) to a bucket multiple; returns the
    original (H, W) for cropping back."""
    H, W = img.shape[1:3]
    ph = (multiple - H % multiple) % multiple
    pw = (multiple - W % multiple) % multiple
    if ph or pw:
        img = np.pad(img, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
    return img, (H, W)


def unpad(img, hw: Tuple[int, int]):
    H, W = hw
    return img[:, :H, :W, :]
