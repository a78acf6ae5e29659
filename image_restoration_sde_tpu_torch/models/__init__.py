from . import modules
from .latent_unet import UNet
from .nafnet import ConditionalNAFNet, NAFBlock
from .unet import ConditionalUNet, init_params_

__all__ = ["modules", "ConditionalNAFNet", "ConditionalUNet", "NAFBlock", "UNet", "init_params_"]
