from . import degradations, img_utils, metrics, options
from .flax_import import (
    bokeh_nafnet_flax_keys,
    dit_flax_keys,
    latent_unet_flax_keys,
    nafnet_flax_keys,
    state_dict_from_flax,
    stereo_nafnet_flax_keys,
    unet_flax_keys,
)
from .img_utils import split_eyes, tensor2img
from .metrics import calculate_psnr, calculate_ssim

__all__ = ["bokeh_nafnet_flax_keys", "calculate_psnr", "calculate_ssim", "degradations", "dit_flax_keys",
           "img_utils", "latent_unet_flax_keys", "metrics", "nafnet_flax_keys", "options", "split_eyes",
           "state_dict_from_flax", "stereo_nafnet_flax_keys", "tensor2img", "unet_flax_keys"]
