from . import modules
from .unet import ConditionalUNet, init_params_

__all__ = ["modules", "ConditionalUNet", "init_params_"]
