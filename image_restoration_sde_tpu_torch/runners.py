"""Task runners for training: build the net, SDE, optimizer and train state
from a YAML, and expose ``step`` and ``validate``.

Counterpart of the tasks of ``image_restoration_sde_tpu/runners.py``:

- ``denoising`` -> :class:`PixelDiffusionTask` (IR-SDE on pixels; covers
  derain/deblur/deshadow/dehaze and the inpainting/sr degradation plugins;
  stereo datasets switch the net to ``StereoConditionalNAFNet``), or
  :class:`GaussianDenoisingTask` (the denoising SDE) when the distortion is
  ``denoising``;
- ``latent`` -> :class:`CompressorTask` (the Refusion compressor, no EMA);
- ``latent_denoising`` -> :class:`LatentDiffusionTask` (IR-SDE on the
  latents of a frozen compressor), or :class:`BokehLatentDiffusionTask`
  (lens conditioning, no EMA) when the dataset mode starts with ``Bokeh``.

Each runner owns its net, SDE, schedule and train state and exposes
``step(state, batch, gen)`` (host-side degradation prep, then one train
step), ``infer(batch, gen)`` (one batch restored through the task's own
sampler: ``(restored NHWC float32, LQ used)``, both numpy),
``validate(state, loader, gen, out_dir, step)`` (PSNR of ``infer``'s
outputs), ``params_trees(state)`` (label -> ``state_dict`` for checkpoints)
and ``maybe_load_pretrained(state)``; the samplers that restore tiles also
``prepare_lq(batch, gen)`` (the LQ ``infer`` feeds its sampler) and
``sample_batch(tiles, gens)``, the ``sample_fn`` of
``tiling.tiled_restore`` and ``tiled_restore_device``.

The net's initial weights are the JAX package's initialisation (flax's
``lecun_normal`` kernels, zero biases, flax's constants), drawn from the
run's seed; so are a latent task's compressor's, unless
``path.pretrain_model_L`` names a ``.pth`` (a
compressor run's ``{iter}_G.pth``, also when spelled ``{iter}_G``, or a
reference file), which it loads on every start, resumed ones included: the
compressor is not part of the train state.

Under tensor parallelism (a ``mesh`` whose model axis is longer than 1)
the trained net is split over its model group (``training.trainer.
tensor_parallel``; every trained net has a plan: DiT, ConditionalUNet,
the NAFNet family and the compressor) before the step goes through DDP
over the data group; a latent task's frozen compressor stays whole on
every rank.  A ``.pth`` loads whole and each rank keeps its slice, and
``params_trees`` is whole.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from .data.io_utils import save_img
from .models import build_network
from .parallel import dist
from .sampling import make_denoising_sampler, make_restoration_sampler, pad_to_bucket, unpad
from .sde import DenoisingSDE, IRSDE
from .training import build_from_options, build_lr_schedule, create_train_state, make_compressor_train_step, \
    make_denoising_train_step, make_latent_sampler, make_latent_train_step, make_train_step
from .training.checkpoint import ema_state_dict, load_params, whole_state
from .training.latent import CrossDecode
from .training.trainer import Remat, data_parallel, tensor_parallel
from .utils import metrics, options
from .utils.degradations import add_noise, mask_to, upscale
from .utils.img_utils import split_eyes, tensor2img


def resolve_device(name: str) -> torch.device:
    """The entry points' ``--device``: the card unless ``cpu`` is asked for;
    without a card, ``cuda`` raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    return device


def effective_distortion(opt) -> str:
    """Infer the degradation plugin.  The reference hardcodes it per task
    directory (some shipped configs carry stale ``distortion`` keys, e.g.
    inpainting says 'derain' — ref config/inpainting/options/train/ir-sde.yml);
    we infer from the telltale config fields instead."""
    deg = opt["degradation"] or {}
    if deg.get("mask_root"):
        return "inpainting"
    if opt["distortion"] == "sr":
        return "sr"
    if opt["distortion"] == "denoising":
        return "denoising"
    if opt["distortion"] is None and (opt["datasets"] or {}).get("train", {}).get("mode") == "GT":
        return "denoising"
    return opt["distortion"] or "paired"


def build_task(opt, seed: int, device, mesh=None):
    """The YAML's task on ``device``; ``mesh`` (``parallel.mesh.make_mesh``'s)
    splits its net over the model axis where that is longer than 1."""
    model_type = opt["model"]
    if model_type == "denoising" and effective_distortion(opt) == "denoising":
        return GaussianDenoisingTask(opt, seed, device, mesh)
    if model_type in ("denoising", "sde"):
        return PixelDiffusionTask(opt, seed, device, mesh)
    if model_type == "latent":
        return CompressorTask(opt, seed, device, mesh)
    if model_type == "latent_denoising":
        if _dataset_mode(opt).startswith("Bokeh"):
            return BokehLatentDiffusionTask(opt, seed, device, mesh)
        return LatentDiffusionTask(opt, seed, device, mesh)
    raise NotImplementedError(f"model type {model_type!r}")


def _dataset_mode(opt) -> str:
    dsets = opt["datasets"] or {}
    for key in ("train", *dsets.keys()):
        if dsets.get(key):
            return dsets[key].get("mode", "")
    return ""


def _seeded_network(which: str, setting: dict, seed: int):
    """The net as built, which is the JAX package's initialisation (flax's
    ``lecun_normal`` kernels, zero biases and flax's constants:
    ``models.modules.lecun_normal_``), drawn from ``seed`` through torch's
    global generator, leaving the caller's generator as it was.
    ``upscale``, which ``options.parse`` adds to the setting of sr
    configs, is dropped: the reference nets take it and do not use it."""
    setting = {k: v for k, v in setting.items() if k != "upscale"}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_network(which, setting)


def _make_irsde(sde_opt, device) -> IRSDE:
    return IRSDE.create(max_sigma=sde_opt["max_sigma"], T=int(sde_opt["T"]), schedule=sde_opt["schedule"],
                        eps=float(sde_opt["eps"]), device=device)


def _sampler_options(sde_opt) -> dict:
    steps = int(sde_opt["sample_T"]) if sde_opt["sample_T"] else None
    return {"mode": sde_opt["sampling_mode"] or "sde", "steps": steps}


def _captures(opt) -> bool:
    """Whether the task's sampler captures its chains on the card: at test
    time (the test, inference and restore entry points: one graph a
    shape), not in a train run's validation, whose nets move between
    validations and may be split over ranks that sample together."""
    return not opt.get("is_train")


class _Base:
    keeps_ema = True  # whether the train state keeps an EMA of the net

    def __init__(self, opt, seed: int, device, which: str, setting: dict, mesh=None):
        self.opt, self.device = opt, torch.device(device)
        self.deg_rng = np.random.default_rng(seed + 77)
        # test-time configs carry no train: section; a zero-lr placeholder
        # keeps train-state construction uniform
        self.train_opt = opt["train"] or options.dict_to_nonedict(
            {"lr_G": 0.0, "lr_scheme": "MultiStepLR", "lr_steps": []}
        )
        self.lr_schedule = build_lr_schedule(self.train_opt)
        self.net = _seeded_network(which, setting, seed).to(self.device).train()
        optimizer = build_from_options(self.train_opt, self.net.parameters(), self.lr_schedule)
        self.state = create_train_state(self.net, optimizer, ema=self.keeps_ema)
        if mesh is not None and mesh.model_size > 1:  # self.net split in place
            tensor_parallel(self.state, mesh)
        if dist.is_initialized():  # under torchrun: the step through DDP; self.net stays bare
            data_parallel(self.state, self._step_module())

    def _step_module(self):
        """The module a train step calls: the net, recomputed in the
        backward where ``train.remat`` says so."""
        return Remat(self.net) if self._loss_kwargs()["remat"] else self.net

    def _loss_kwargs(self):
        t = self.train_opt
        return dict(
            loss_type=t["loss_type"] or "l1",
            is_weighted=bool(t["is_weighted"]),
            weight=float(t["weight"] or 1.0),
            remat=bool(t.get("remat")),
        )

    def n_params(self) -> int:
        return sum(p.numel() for p in self.net.parameters())

    def params_trees(self, state) -> Dict[str, dict]:
        """label -> whole ``state_dict`` (under tensor parallelism a
        collective of the model group)."""
        whole = whole_state(state)
        trees = {"G": whole["net"]}
        if state.ema is not None:
            trees["EMA"] = ema_state_dict(state, whole)
        return trees

    def _load(self, net, path: str, layout=None) -> None:
        """A whole ``.pth`` into ``net``; a split net (``layout``) keeps its
        slices."""
        sd = load_params(path)
        net.load_state_dict(sd if layout is None else layout.shard(sd),
                            strict=self.opt["path"]["strict_load"] is not False)

    def maybe_load_pretrained(self, state) -> None:
        """Load ``path.pretrain_model_G`` into the net.  On resume,
        ``options.check_resume`` points it at the resumed iteration's
        ``{iter}_G.pth`` (the reference's semantics)."""
        if self.opt["path"]["pretrain_model_G"]:
            self._load(state.net, self.opt["path"]["pretrain_model_G"], state.layout)

    def extra_state(self) -> dict:
        """What a checkpoint keeps of the runner: its degradation generator."""
        return {"deg_rng": self.deg_rng.bit_generator.state}

    def load_extra_state(self, extra: dict) -> None:
        if "deg_rng" in extra:
            self.deg_rng.bit_generator.state = extra["deg_rng"]

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    def _save_val_images(self, out_img, out_dir, step, i):
        """Save the first few validation outputs; stereo (6-channel) outputs
        as one PNG per eye (ref stereo-sr/train.py:282-287)."""
        if i < 3:
            for eye, img in split_eyes(out_img):
                save_img(img, os.path.join(out_dir, f"{step}_{i}{eye}.png"))

    def _sample(self, x: torch.Tensor, gen, batch) -> torch.Tensor:
        """The task's sampler on the padded LQ ``x`` of ``batch``: by default
        its ``sample_batch``."""
        return self.sample_batch(x, gen)

    def infer(self, batch, gen) -> Tuple[np.ndarray, np.ndarray]:
        """(restored NHWC float32, LQ used): ``prepare_lq``, padded to the
        64 bucket, through the task's sampler, unpadded."""
        lq = self.prepare_lq(batch, gen)
        vlq, hw = pad_to_bucket(lq, 64)
        return unpad(self._sample(self._tensor(vlq), gen, batch), hw).cpu().numpy(), lq

    def validate(self, state, loader, gen: torch.Generator, out_dir, step) -> Dict[str, float]:
        """PSNR of ``infer`` (every image drawing from ``gen``) against the
        GT over the first ``max_images`` validation batches, the net in eval
        mode; rank 0 alone saves images (a split net's model group samples
        together)."""
        max_val = self.opt["datasets"]["val"]["max_images"] or 16
        avg_psnr, n = 0.0, 0
        self.net.eval()
        try:
            for i, vb in enumerate(loader):
                if i >= max_val:
                    break
                out, _ = self.infer(vb, gen)
                out_img = tensor2img(out[0])
                avg_psnr += metrics.calculate_psnr(out_img, tensor2img(vb["GT"][0]))
                n += 1
                if dist.process_is_primary():
                    self._save_val_images(out_img, out_dir, step, i)
        finally:
            self.net.train()
        return {"psnr": avg_psnr / max(1, n)}


class PixelDiffusionTask(_Base):
    """IR-SDE on pixels (ref DenoisingModel, denoising_model.py:25-199)."""

    def __init__(self, opt, seed: int, device, mesh=None):
        which, setting = options.network_setting(opt)
        if _dataset_mode(opt).startswith("Ste") and which == "ConditionalNAFNet":
            # the stereo-sr task dir ships its own ConditionalNAFNet with
            # SCAM fusion under the same class name (SURVEY §2.2)
            which = "StereoConditionalNAFNet"
        super().__init__(opt, seed, device, which, setting, mesh)
        self.sde = _make_irsde(opt["sde"], self.device)
        self._train_step = make_train_step(self.sde, **self._loss_kwargs())
        self.sampler = make_restoration_sampler(self.sde, self.net, **_sampler_options(opt["sde"]),
                                                capture=_captures(opt))

    def prepare_pair(self, batch, shard=None) -> Tuple[np.ndarray, np.ndarray]:
        """(LQ, GT) of ``batch``; a train step's ``shard`` (rank, world)
        draws the global batch's inpainting masks and keeps its rows'."""
        distortion = effective_distortion(self.opt)
        if distortion == "inpainting":
            gt = batch["GT"]
            lq = mask_to(gt, self.opt["degradation"]["mask_root"], rng=self.deg_rng, shard=shard)
            return lq.astype(np.float32), gt
        if distortion == "sr":
            return (
                upscale(batch["LQ"], int(self.opt["degradation"]["scale"])).astype(np.float32),
                batch["GT"],
            )
        return batch["LQ"], batch["GT"]

    def step(self, state, batch, gen: torch.Generator):
        lq, gt = self.prepare_pair(batch, state.shard)
        return self._train_step(state, self._tensor(lq), self._tensor(gt), gen)

    def prepare_lq(self, batch, gen=None) -> np.ndarray:
        """The sampler's LQ: the pair's (an LQ-only batch stands in for its
        GT), made from the GT for inpainting (the mask), SR upscaled."""
        if "GT" not in batch:
            batch = {**batch, "GT": batch["LQ"]}
        return np.asarray(self.prepare_pair(batch)[0])

    def sample_batch(self, tiles: torch.Tensor, gens) -> torch.Tensor:
        return self.sampler(tiles, gens)


class GaussianDenoisingTask(_Base):
    """DenoisingSDE task (ref config/denoising-sde, §3.4): GT-only data, the
    noisy state is the input; sigma^2-weighted loss; validation is the
    reverse ODE from the optimal timestep for the degradation sigma."""

    def __init__(self, opt, seed: int, device, mesh=None):
        which, setting = options.network_setting(opt)
        super().__init__(opt, seed, device, which, {**setting, "conditional": False}, mesh)
        sde_opt = opt["sde"]
        self.sde = DenoisingSDE.create(max_sigma=sde_opt["max_sigma"], T=int(sde_opt["T"]),
                                       schedule=sde_opt["schedule"], device=self.device)
        kwargs = self._loss_kwargs()
        if self.train_opt["is_weighted"] is None:
            kwargs["is_weighted"] = True
        self._train_step = make_denoising_train_step(self.sde, **kwargs)
        self.sigma = float(opt["degradation"]["sigma"])
        self.sampler = make_denoising_sampler(self.sde, self.net, self.sigma, capture=_captures(opt))

    def step(self, state, batch, gen: torch.Generator):
        return self._train_step(state, self._tensor(batch["GT"]), gen)

    def prepare_lq(self, batch, gen) -> np.ndarray:
        """The batch's noisy LQ, else its GT plus noise of ``sigma`` drawn
        from ``gen``."""
        if "LQ" in batch:
            return np.asarray(batch["LQ"], np.float32)
        return add_noise(self._tensor(batch["GT"]), gen, self.sigma).cpu().numpy()

    def sample_batch(self, tiles: torch.Tensor, gens=None) -> torch.Tensor:
        return self.sampler(tiles)  # the reverse ODE draws nothing


class CompressorTask(_Base):
    """Refusion compressor pre-training (ref unet-latent LatentModel): the
    compressor ``UNet`` of ``network_L`` (else ``network_G``) trained on the
    cross-reconstruction objective, no EMA; validation is the PSNR of the GT
    latent decoded with the LQ skips."""

    keeps_ema = False

    def __init__(self, opt, seed: int, device, mesh=None):
        which, setting = options.network_setting(opt, "network_L" if opt["network_L"] else "network_G")
        super().__init__(opt, seed, device, which, setting, mesh)
        t = self.train_opt
        self._train_step = make_compressor_train_step(loss_type=t["loss_type"] or "l1",
                                                      weight=float(t["weight"] or 1.0))

    def maybe_load_pretrained(self, state) -> None:
        """On resume, the resumed iteration's ``{iter}_G.pth``, to which
        ``options.check_resume`` points ``pretrain_model_G``; otherwise
        ``pretrain_model_L``, else ``pretrain_model_G``, as the JAX task
        prefers them (it skips loading on resume, where orbax restores the
        parameters)."""
        path = self.opt["path"]
        load = path["pretrain_model_L"] or path["pretrain_model_G"]
        if path["resume_state"]:
            load = path["pretrain_model_G"]
        if load:
            self._load(state.net, load, state.layout)

    def _step_module(self):
        return CrossDecode(self.net)

    def step(self, state, batch, gen: torch.Generator):
        return self._train_step(state, self._tensor(batch["LQ"]), self._tensor(batch["GT"]), gen)

    @torch.inference_mode()
    def infer(self, batch, gen=None) -> Tuple[np.ndarray, np.ndarray]:
        """The cross decode: the GT's latent (the LQ's where the batch has
        no GT) decoded with the LQ's skips.  Draws nothing."""
        lq, hw = pad_to_bucket(np.asarray(batch["LQ"]), 64)
        gt, _ = pad_to_bucket(np.asarray(batch.get("GT", batch["LQ"])), 64)
        _, h_lq = self.net.encode(self._tensor(lq))
        l_gt, _ = self.net.encode(self._tensor(gt))
        return unpad(self.net.decode(l_gt, h_lq), hw).cpu().numpy(), np.asarray(batch["LQ"])


class LatentDiffusionTask(_Base):
    """Refusion: IR-SDE on the latents of the frozen compressor of
    ``network_L`` (ref latent_denoising_model.py:26-236); validation through
    the latent sampler."""

    def __init__(self, opt, seed: int, device, mesh=None):
        which, setting = self._score_network(opt)
        super().__init__(opt, seed, device, which, setting, mesh)
        which_l, setting_l = options.network_setting(opt, "network_L")
        self.compressor = _seeded_network(which_l, setting_l, seed + 1).to(self.device)
        self.sde = _make_irsde(opt["sde"], self.device)
        self._train_step = make_latent_train_step(self.sde, self.compressor, **self._loss_kwargs())
        self.sampler = make_latent_sampler(self.sde, self.net, self.compressor, **_sampler_options(opt["sde"]),
                                           capture=_captures(opt))

    @staticmethod
    def _score_network(opt) -> tuple:
        return options.network_setting(opt)

    def maybe_load_pretrained(self, state) -> None:
        """The compressor from ``pretrain_model_L`` (on resume too), then the
        score net as the pixel tasks load it."""
        if self.opt["path"]["pretrain_model_L"]:
            self.compressor.load_state_dict(load_params(self.opt["path"]["pretrain_model_L"]))
        super().maybe_load_pretrained(state)

    def _cond(self, batch):
        return None

    def step(self, state, batch, gen: torch.Generator):
        return self._train_step(state, self._tensor(batch["LQ"]), self._tensor(batch["GT"]), gen, self._cond(batch))

    def prepare_lq(self, batch, gen=None) -> np.ndarray:
        return np.asarray(batch["LQ"], np.float32)

    def sample_batch(self, tiles: torch.Tensor, gens) -> torch.Tensor:
        return self.sampler(tiles, gens)

    def _sample(self, x: torch.Tensor, gen, batch) -> torch.Tensor:
        return self.sampler(x, gen, self._cond(batch))


class BokehLatentDiffusionTask(LatentDiffusionTask):
    """Latent diffusion with lens conditioning (ref latent-bokeh
    latent_denoising_model.py:143-189): ``ConditionalNAFNet`` becomes
    ``BokehConditionalNAFNet``, the batch's ``src_lens``, ``tgt_lens`` and
    ``disparity`` go to it as ``cond``; no EMA (the reference comments its
    update out)."""

    keeps_ema = False
    # an image's lens values condition the whole image: its tiles have none
    # of their own, so the task restores no tiles (as in the JAX package)
    sample_batch = None

    @staticmethod
    def _score_network(opt) -> tuple:
        which, setting = options.network_setting(opt)
        return ("BokehConditionalNAFNet" if which == "ConditionalNAFNet" else which), setting

    def _cond(self, batch):
        return tuple(self._tensor(batch[k]).reshape(-1) for k in ("src_lens", "tgt_lens", "disparity"))
