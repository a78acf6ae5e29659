"""Refusion's latent restoration: the compressor (``compressor.which``)
encodes, the score net (``score_net.which``) runs the reverse chain on the
latent, the compressor decodes; ``training.make_latent_sampler``, all three
captured as one CUDA graph a signature."""

from benchmark.reference.sde import truncated


class System:
    def build(self, run):
        from image_restoration_sde_tpu_torch.sde import IRSDE
        from image_restoration_sde_tpu_torch.training import make_latent_sampler

        net = run.port_net("score", run.config["score_net"])
        compressor = run.port_net("compressor", run.config["compressor"])
        self.latent = tuple(compressor.latent_shape((run.batch, run.H, run.W)))
        sde = IRSDE.create(device=run.device, **run.config["sde"])
        sampler = make_latent_sampler(sde, net, compressor, mode=run.mode, capture=True)
        run.graphs.append(sampler.graphs)
        return sampler

    def noise_shape(self, run, batch: int, H: int, W: int) -> tuple:
        return self.latent

    def reference_call(self, ref, x, noise, mode: str, steps=None):
        latent, hs = ref["compressor"].encode(x)
        out = truncated(ref["sde"], steps).reverse(ref["score"], latent, noise, mode)
        return ref["compressor"].decode(out, hs, x.shape[1:3])
