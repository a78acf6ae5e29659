"""High-level restoration sampling API (PyTorch).

Counterpart of ``image_restoration_sde_tpu/sampling.py``: start from the
noised LQ image (``noise_state``) and run the chosen reverse sampler; or,
for the denoising SDE, run the reverse ODE from the noisy image at the
timestep of its noise level.  Any image size runs as it is;
``pad_to_bucket`` / ``unpad`` reflect-pad to a bucket multiple and crop
back, as the JAX package does for its compiled shapes.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .sde import DenoisingSDE, IRSDE, samplers
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


def run_chunks(sample_one: Callable, lq: torch.Tensor, gen: GeneratorLike, chunk: Optional[int], cond=None):
    """``sample_one(lq_chunk, gen_chunk)`` over the batch's sub-batches;
    with a per-sample ``cond`` (a tuple of tensors with the batch as their
    first axis), ``sample_one(lq_chunk, gen_chunk, cond_chunk)``."""
    B = lq.shape[0]
    c = _sample_chunk(B, chunk)
    outs = []
    for i in range(0, B, c):
        args = [lq[i : i + c], gen[i : i + c] if is_generator_batch(gen) else gen]
        if cond is not None:
            args.append(tuple(v[i : i + c] for v in cond))
        outs.append(sample_one(*args))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def make_restoration_sampler(
    sde: IRSDE,
    net: nn.Module,  # net(xt, cond, tvec) -> noise, NHWC
    mode: str = "posterior",
    steps: Optional[int] = None,
    chunk: Optional[int] = None,
    cast_params=None,
) -> Callable:
    """Returns ``sample(lq, gen) -> restored`` (NHWC float32).

    ``gen`` is one ``torch.Generator`` for the batch, or one per sample (then
    sample i's noise depends only on generator i).  ``chunk`` splits the
    batch into sub-batches run one after the other; the default runs the
    whole batch at once.  ``cast_params`` runs the net with its float32
    parameters cast to that dtype, once per call."""
    check_mode(mode)

    @torch.inference_mode()
    def sample(lq: torch.Tensor, gen: GeneratorLike) -> torch.Tensor:
        noise_fn = make_noise_fn(net, cast_params)

        def sample_one(x, g):
            return reverse(sde, noise_fn, sde.noise_state(g, x), x, g, mode, steps)

        return run_chunks(sample_one, lq, gen, chunk)

    return sample


def make_denoising_sampler(
    sde: DenoisingSDE,
    net: nn.Module,  # net(x, None, tvec) -> noise, NHWC
    sigma: float,
    cast_params=None,
) -> Callable:
    """Returns ``sample(noisy) -> denoised`` (NHWC float32): the reverse ODE
    from ``noisy`` over ``t0`` steps, ``t0 = sde.get_optimal_timestep(sigma)``
    computed once, here.  Deterministic: no generator.  ``cast_params`` as
    in :func:`make_restoration_sampler`."""
    t0 = sde.get_optimal_timestep(sigma)

    @torch.inference_mode()
    def sample(noisy: torch.Tensor) -> torch.Tensor:
        noise_fn = make_noise_fn(net, cast_params)
        return samplers.dsde_reverse_ode(sde, lambda x, tvec: noise_fn(x, None, tvec), noisy, steps=t0)

    sample.t0 = t0
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
