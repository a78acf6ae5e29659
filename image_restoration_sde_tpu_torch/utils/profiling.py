"""Profiling: a trace of a block of steps, a step timer, FLOP counts and MFU.

Counterpart of ``image_restoration_sde_tpu/utils/profiling.py``:
``torch.profiler`` in place of ``jax.profiler`` (a Chrome trace, which
Perfetto and ``chrome://tracing`` open), the same :class:`StepTimer`, and
FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` in place of XLA's
cost analysis.  The counter sees the convolutions and matrix products of
torch's operators and, through the formulas every ``irsde::`` operator
registers (``kernels.define_op``), the work of the port's kernels, which it
cannot see into; the operators' backwards are plain compositions, counted
as what they run.

Peaks are the published dense rates of the card by its
``torch.cuda.get_device_name()``; an unknown card raises rather than
guessing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

# published dense peaks (NVIDIA's H100 SXM data sheet, at the full 700 W):
# float32 outside the tensor cores, TF32 and bfloat16 on them, FLOP/s
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12},
}


def peak_flops(dtype: str, device=None) -> float:
    """The card's published peak FLOP/s for ``dtype`` (``float32``,
    ``tf32`` or ``bfloat16``)."""
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_FLOPS:
        raise KeyError(f"no published peak for {name!r}; known: {sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[name][dtype]


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the enclosed block (host and card
    activity), written to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Separates the first call (warm-up: kernel builds, cuDNN's choices,
    allocator growth) from steady-state step times.  The block should end
    in a synchronisation where it runs on the card."""

    def __init__(self):
        self.compile_s: Optional[float] = None
        self.times = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if self.compile_s is None:
            self.compile_s = dt
        else:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"compile_s": self.compile_s or 0.0}
        arr = np.asarray(self.times)
        return {
            "compile_s": self.compile_s or 0.0,
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }


def count_flops(fn: Callable, *args, **kwargs) -> tuple:
    """``(FLOPs, fn's result)`` of one call of ``fn``, counted by
    ``FlopCounterMode`` (the ``irsde::`` operators by their formulas); the
    call runs for real."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return counter.get_total_flops(), out


def estimate_mfu(flops: float, seconds: float, peak: float) -> float:
    """Model FLOPs utilisation: ``flops`` done in ``seconds`` over the peak
    rate ``peak`` (FLOP/s)."""
    return flops / (peak * seconds)
