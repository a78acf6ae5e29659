from .flash_attention import FLASH_ATTN, flash_mha, flash_mha_plain
from .layernorm import LAYERNORM, channel_layernorm, channel_layernorm_plain
from .linear_attention import (
    LA_APPLY,
    LA_CTX,
    linear_attention_packed,
    linear_attention_packed_plain,
)
# the module ops.naf_stack keeps its name: its entry point naf_stack is
# not re-exported here
from .naf_stack import NAF_STACK, naf_stack_plain, stack_middle_params

KERNELS = (LAYERNORM, LA_CTX, LA_APPLY, NAF_STACK, FLASH_ATTN)

__all__ = [
    "FLASH_ATTN",
    "KERNELS",
    "LAYERNORM",
    "LA_APPLY",
    "LA_CTX",
    "NAF_STACK",
    "channel_layernorm",
    "channel_layernorm_plain",
    "flash_mha",
    "flash_mha_plain",
    "linear_attention_packed",
    "linear_attention_packed_plain",
    "naf_stack_plain",
    "stack_middle_params",
]
