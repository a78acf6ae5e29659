"""Web demo of the PyTorch port: drop an image, get it restored.

    python -m image_restoration_sde_tpu_torch.app -opt=<test yml> [--port 7860]
        [--src-lens 18 --tgt-lens -160 --disparity 1] [--seed 0] [--device cuda|cpu]

Counterpart of ``tools/app.py`` (ref ``config/deraining/app.py:27-38``; the
latent bokeh task takes the lens values as flags, ref
``config/latent-bokeh/app.py:28-49``): the test YAML's task runner, its
weights where ``path.pretrain_model_G`` names a ``.pth`` (seeded ones
otherwise), and a ``gradio`` interface over :func:`make_restore`'s
callable.  ``gradio`` is imported in :func:`main` alone, so the callable
builds and runs without it.  It runs on the card unless ``--device cpu``
is given; without a card it raises.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import numpy as np

from .runners import build_task, resolve_device
from .sde import rng
from .utils import options
from .utils.img_utils import tensor2img


def make_restore(opt_path: str, device="cuda", lens=(18.0, -160.0, 1.0), seed: int = 0) -> Callable:
    """``restore(img) -> img``: a uint8 HWC RGB image restored by the
    YAML's task (``infer``, its noise from a generator seeded with
    ``seed``), returned as uint8.  A bokeh task takes ``lens`` =
    (source lens, target lens, disparity)."""
    device = resolve_device(str(device))
    opt = options.dict_to_nonedict(options.parse(opt_path, is_train=False))
    task = build_task(opt, seed, device)
    task.maybe_load_pretrained(task.state)
    task.net.eval()
    bokeh = any((d or {}).get("mode", "").startswith("Bokeh") for d in (opt["datasets"] or {}).values())

    def restore(img: np.ndarray) -> np.ndarray:
        batch = {"LQ": np.asarray(img).astype(np.float32)[None, ..., :3] / 255.0}
        if bokeh:
            batch.update({k: np.full((1,), v, np.float32)
                          for k, v in zip(("src_lens", "tgt_lens", "disparity"), lens)})
        out, _ = task.infer(batch, rng.generator(seed, device))
        return tensor2img(out[0])

    restore.title = f"image-restoration-sde (PyTorch, {device.type}) - {opt['name']}"
    return restore


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, required=True, help="Path to a test option YAML file.")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--src-lens", type=float, default=18.0)
    parser.add_argument("--tgt-lens", type=float, default=-160.0)
    parser.add_argument("--disparity", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("the web demo needs the 'gradio' package; make_restore's callable runs without it")

    restore = make_restore(args.opt, args.device, (args.src_lens, args.tgt_lens, args.disparity), args.seed)
    demo = gr.Interface(fn=restore, inputs=gr.Image(type="numpy", label="degraded input"),
                        outputs=gr.Image(type="numpy", label="restored output"), title=restore.title)
    demo.launch(server_port=args.port)


if __name__ == "__main__":
    main()
