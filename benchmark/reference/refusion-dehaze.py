"""Plain reference of ``configs/refusion-dehaze.json``: Refusion's latent
dehazing, the compressor UNet (ch 8, ch_mult [4, 8, 8, 16], embed_dim 8,
float32) around a ConditionalNAFNet (width 64, enc [1, 1, 1, 28]) on the
cosine IR-SDE."""

import torch

from benchmark.reference import nets, sde
from benchmark.reference.precision import Precision


def build(config: dict, device, prec: Precision) -> dict:
    """``{"score": net, "compressor": UNet, "sde": IRSDE}`` in float32 on
    ``device``, each rounded by ``prec``."""
    with torch.device(device):
        net = nets.network(config["score_net"], "ConditionalNAFNet", prec)
        compressor = nets.network(config["compressor"], "UNet", prec)
    return {"score": net, "compressor": compressor, "sde": sde.IRSDE(device=device, **config["sde"])}
