from .flax_import import (
    bokeh_nafnet_flax_keys,
    dit_flax_keys,
    latent_unet_flax_keys,
    nafnet_flax_keys,
    state_dict_from_flax,
    stereo_nafnet_flax_keys,
    unet_flax_keys,
)

__all__ = ["bokeh_nafnet_flax_keys", "dit_flax_keys", "latent_unet_flax_keys", "nafnet_flax_keys",
           "state_dict_from_flax", "stereo_nafnet_flax_keys", "unet_flax_keys"]
