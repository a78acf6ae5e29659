from . import modules
from .bokeh_nafnet import BokehConditionalNAFNet
from .dit import DiT
from .latent_unet import UNet
from .nafnet import ConditionalNAFNet, NAFBlock
from .registry import build_network
from .stereo_nafnet import StereoConditionalNAFNet
from .unet import ConditionalUNet, init_params_

__all__ = ["modules", "BokehConditionalNAFNet", "ConditionalNAFNet", "ConditionalUNet", "DiT", "NAFBlock",
           "StereoConditionalNAFNet", "UNet", "build_network", "init_params_"]
