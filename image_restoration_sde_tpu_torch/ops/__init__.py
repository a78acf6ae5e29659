from .flash_attention import FLASH_ATTN, flash_mha, flash_mha_plain
from .layernorm import LAYERNORM, channel_layernorm, channel_layernorm_plain
from .linear_attention import (
    LA_APPLY,
    LA_CTX,
    LIN_ATTN_APPLY,
    LIN_ATTN_CTX,
    linear_attention_packed,
    linear_attention_packed_plain,
    linear_attention_plain,
)
# the modules ops.naf_stack and ops.linear_attention keep their names:
# their entry points naf_stack and linear_attention are not re-exported here
from .naf_stack import NAF_STACK, naf_stack_plain, stack_middle_params

KERNELS = (LAYERNORM, LA_CTX, LA_APPLY, NAF_STACK, FLASH_ATTN, LIN_ATTN_CTX, LIN_ATTN_APPLY)

__all__ = [
    "FLASH_ATTN",
    "KERNELS",
    "LAYERNORM",
    "LA_APPLY",
    "LA_CTX",
    "LIN_ATTN_APPLY",
    "LIN_ATTN_CTX",
    "NAF_STACK",
    "channel_layernorm",
    "channel_layernorm_plain",
    "flash_mha",
    "flash_mha_plain",
    "linear_attention_packed",
    "linear_attention_packed_plain",
    "linear_attention_plain",
    "naf_stack_plain",
    "stack_middle_params",
]
