"""Weights and inputs made from a run's seed, on the device, in few calls.

Weights follow the names and shapes of a reference network's state dict,
which is the port's key space too: one normal draw for all of them on the
device, cut into the tensors and scaled: kernels N(0, 1/fan_in) (fan_in =
the elements of one output's slice), NAFBlock ``beta`` and ``gamma``
N(0, 0.2^2), biases 0, LayerNorm gains 1.  The same seed gives the same
tensors on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

RESIDUAL_SCALE = 0.2
PURPOSES = {"weights": 0, "inputs": 1, "noise": 2, "sample": 5}


def derive(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for one purpose of a run seeded with ``seed``."""
    state = np.random.SeedSequence((int(seed) % 2**64, PURPOSES[purpose], int(index) % 2**64)).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _scale(name: str, shape: torch.Size) -> float:
    if name.endswith(".g"):
        return 0.0
    if name.endswith("bias"):
        return 0.0
    if name.endswith(("beta", "gamma")):
        return RESIDUAL_SCALE
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    return fan_in**-0.5


def make_state_dict(shapes: dict, seed: int, part: int, device) -> dict:
    """``{name: tensor}`` for ``{name: shape}``, float32 on ``device``: the
    weights of network ``part`` (0 the score net, 1 the compressor) of a run
    seeded with ``seed``."""
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, generator=generator(derive(seed, "weights", part), device), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        t = flat[at : at + n].view(shape)
        at += n
        if name.endswith(".g"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = t.mul_(_scale(name, shape))
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def uniform_images(seed: int, index: int, shape: tuple, device) -> torch.Tensor:
    """Images in [0, 1) of ``shape`` (NHWC), item ``index`` of a run."""
    return torch.rand(shape, generator=generator(derive(seed, "inputs", index), device), device=device)
