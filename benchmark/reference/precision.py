"""The reference in a lower precision: the control of ``correct``.

The reference computes in float32.  ``Precision("float8_e4m3")``, the
precision just below the bfloat16 compute that the configurations state,
runs every convolution and dense layer with its operands and results
rounded to float8 with a scale a tensor (its largest magnitude on the
format's largest finite value, as float8 inference scales), the products
accumulating in float32 as the card's float8 tensor cores accumulate: the
control of ``correct``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FORMATS = ("float32", "float8_e4m3")
F8_MAX = 448.0


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in FORMATS:
            raise ValueError(f"precision {name!r}; options: {FORMATS}")
        self.name = name

    def round(self, t):
        """``t`` rounded to float8 (float32 leaves it), in float32."""
        if self.name != "float8_e4m3" or t is None or t.device.type == "meta":
            return t
        scale = t.abs().amax().clamp_min(1e-30) / F8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def _run(self, op, x, w, b, *args):
        return self.round(op(self.round(x), self.round(w), self.round(b), *args))

    def conv2d(self, x, w, b, stride, padding, groups):
        return self._run(F.conv2d, x, w, b, stride, padding, 1, groups)

    def linear(self, x, w, b):
        return self._run(F.linear, x, w, b)
