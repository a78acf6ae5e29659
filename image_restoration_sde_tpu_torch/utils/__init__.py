from .flax_import import state_dict_from_flax, unet_flax_keys

__all__ = ["state_dict_from_flax", "unet_flax_keys"]
