from .latent import make_latent_sampler

__all__ = ["make_latent_sampler"]
