from .flax_import import (
    dit_flax_keys,
    latent_unet_flax_keys,
    nafnet_flax_keys,
    state_dict_from_flax,
    unet_flax_keys,
)

__all__ = ["dit_flax_keys", "latent_unet_flax_keys", "nafnet_flax_keys", "state_dict_from_flax", "unet_flax_keys"]
