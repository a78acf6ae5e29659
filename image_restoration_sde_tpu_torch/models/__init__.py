from . import modules
from .dit import DiT
from .latent_unet import UNet
from .nafnet import ConditionalNAFNet, NAFBlock
from .registry import build_network
from .unet import ConditionalUNet, init_params_

__all__ = ["modules", "ConditionalNAFNet", "ConditionalUNet", "DiT", "NAFBlock", "UNet", "build_network",
           "init_params_"]
