from .layernorm import LAYERNORM, channel_layernorm, channel_layernorm_plain
from .linear_attention import (
    LA_APPLY,
    LA_CTX,
    linear_attention_packed,
    linear_attention_packed_plain,
)

KERNELS = (LAYERNORM, LA_CTX, LA_APPLY)

__all__ = [
    "KERNELS",
    "LAYERNORM",
    "LA_APPLY",
    "LA_CTX",
    "channel_layernorm",
    "channel_layernorm_plain",
    "linear_attention_packed",
    "linear_attention_packed_plain",
]
