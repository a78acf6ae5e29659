"""Plain reference of ``configs/irsde-derain.json``: IR-SDE deraining's
ConditionalUNet (in_nc 3, out_nc 3, nf 64, depth 4) on the cosine IR-SDE."""

import torch

from benchmark.reference import nets, sde
from benchmark.reference.precision import Precision


def build(config: dict, device, prec: Precision) -> dict:
    """``{"score": net, "sde": IRSDE}`` in float32 on ``device``, rounded by
    ``prec``."""
    score = config["score_net"]
    with torch.device(device):
        net = nets.network(score, "ConditionalUNet", prec)
    return {"score": net, "sde": sde.IRSDE(device=device, **config["sde"])}
