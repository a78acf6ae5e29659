"""Parameters and FLOPs of a YAML's score net and compressor:

    python -m image_restoration_sde_tpu_torch.count_flops -opt=<yml> [--height 750 --width 500] [--device cuda|cpu]

Counterpart of ``tools/count_flops.py`` (ref
``config/latent-dehazing/count_flops.py:22-26``, torchsummaryX over a
1x8x750x500 latent and a 1x3x6000x4000 image through the compressor): one
forward of the score net of ``network_G`` on a ``--height`` x ``--width``
input of its channels, and of the compressor of ``network_L`` (encode and
decode) on an image of that size, counted by
``utils.profiling.count_flops`` (``FlopCounterMode``, the ``irsde::``
operators by their formulas).  The forwards run for real, on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from .models import build_network
from .runners import resolve_device
from .utils import options
from .utils.profiling import count_flops


def _net(opt, key: str, device):
    which, setting = options.network_setting(opt, key)
    net = build_network(which, {k: v for k, v in setting.items() if k != "upscale"})
    return which, setting, net.to(device).eval()


@torch.inference_mode()
def count(opt, height: int, width: int, device) -> dict:
    """``{label: (parameters, forward FLOPs)}`` of the score net and, where
    the YAML has one, the compressor."""
    which, setting, net = _net(opt, "network_G", device)
    ch = int(setting.get("in_nc") or setting.get("img_channel") or setting.get("in_channels") or 3)
    x = torch.zeros((1, height, width, ch), device=device)
    out = {which: (sum(p.numel() for p in net.parameters()),
                   count_flops(net, x, x, torch.tensor([50.0], device=device))[0])}
    if opt["network_L"]:
        which_l, setting_l, comp = _net(opt, "network_L", device)
        img = torch.zeros((1, height, width, int(setting_l.get("in_ch") or 3)), device=device)
        out[f"{which_l} compressor"] = (sum(p.numel() for p in comp.parameters()), count_flops(comp, img)[0])
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--height", type=int, default=750)
    parser.add_argument("--width", type=int, default=500)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where to run (default: the card)")
    args = parser.parse_args(argv)
    opt = options.dict_to_nonedict(options.parse(args.opt, is_train=False))
    for label, (n_params, flops) in count(opt, args.height, args.width, resolve_device(args.device)).items():
        print(f"[{label}] params: {n_params / 1e6:.2f} M, forward FLOPs @ {args.height}x{args.width}: "
              f"{flops / 1e9:.2f} G")
    return 0


if __name__ == "__main__":
    sys.exit(main())
