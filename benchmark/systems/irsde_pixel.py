"""IR-SDE in pixel space: the score net named by the configuration's
``score_net.which`` on the reverse chain of ``sampling.make_restoration_sampler``
(captured: one CUDA graph a signature)."""

from benchmark.reference.sde import truncated


class System:
    def build(self, run):
        from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
        from image_restoration_sde_tpu_torch.sde import IRSDE

        net = run.port_net("score", run.config["score_net"])
        sde = IRSDE.create(device=run.device, **run.config["sde"])
        sampler = make_restoration_sampler(sde, net, mode=run.mode, capture=True)
        run.graphs.append(sampler.graphs)
        return sampler

    def noise_shape(self, run, batch: int, H: int, W: int) -> tuple:
        return (batch, H, W, 3)

    def reference_call(self, ref, x, noise, mode: str, steps=None):
        return truncated(ref["sde"], steps).reverse(ref["score"], x, noise, mode)
