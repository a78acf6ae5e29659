"""The rank side of ``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tp_nafnet.py``: what their spawned gloo ranks run (``parallel.dist.spawn`` imports a rank's function
by its module's path), kept apart so that a rank imports no JAX.  It holds
no tests itself; the parent process calls the same functions at one rank
for the one-process side."""

import copy
import os

import torch
import torch.nn.functional as F
from torch import nn

from image_restoration_sde_tpu_torch import dryrun, runners
from image_restoration_sde_tpu_torch.models import ConditionalUNet, DiT, init_params_
from image_restoration_sde_tpu_torch.models.modules import Conv2d, Linear
from image_restoration_sde_tpu_torch.parallel import dist
from image_restoration_sde_tpu_torch.parallel.mesh import make_mesh
from image_restoration_sde_tpu_torch.parallel.tensor import COLUMN, ROW, Split, parallelize
from image_restoration_sde_tpu_torch.training import build_from_options, build_lr_schedule, checkpoint, \
    create_train_state, make_train_step
from image_restoration_sde_tpu_torch.training.trainer import data_parallel, tensor_parallel
from image_restoration_sde_tpu_torch.utils import options

# the tiny DiT: DiT-L/2's structure at hidden 128, 4 heads, depth 2
DIT = dict(in_channels=4, hidden_size=128, depth=2, num_heads=4)


class Toy(nn.Module):
    """One split layer of each kind: an MLP (column, then row), a 6-chunk
    modulation gathered after its column split, a convolution whose input
    channels are split, fed channels_last."""

    def __init__(self):
        super().__init__()
        self.col, self.row, self.mod = Linear(16, 32), Linear(32, 16), Linear(16, 48)
        self.conv = Conv2d(64, 8, 3, padding=1)

    def forward(self, x, img):
        return self.row(F.gelu(self.col(x))), self.mod(x), self.conv(img)

    @staticmethod
    def tensor_parallel_plan(size):
        return {"col": Split(COLUMN), "row": Split(ROW), "mod": Split(COLUMN, 6, gather=True), "conv": Split(ROW)}


def split_layers(mesh) -> dict:
    """The toy's outputs, input gradients and assembled parameter gradients,
    whole net against split net on the same inputs (one cotangent each)."""
    torch.manual_seed(0)
    whole = Toy()
    split = copy.deepcopy(whole)
    layout = parallelize(split, mesh)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 16, generator=gen)
    img = torch.randn(2, 64, 5, 5, generator=gen).contiguous(memory_format=torch.channels_last)
    out = {}
    for tag, net in (("whole", whole), ("split", split)):
        xs, imgs = x.clone().requires_grad_(), img.clone().requires_grad_()
        ys = net(xs, imgs)
        sum((y * (i + 1)).sum() for i, y in enumerate(ys)).backward()
        grads = {k: p.grad for k, p in net.named_parameters()}
        out[tag] = {"outputs": [y.detach() for y in ys], "x_grad": xs.grad, "img_grad": imgs.grad,
                    "grads": grads if tag == "whole" else layout.whole(grads)}
    out["split_params"] = sorted(layout.splits)
    return out


def dit():
    return init_params_(DiT(**DIT), torch.Generator().manual_seed(3))


def unet():
    """The dry run's UNet (nf 16, depth 2), seeded."""
    return init_params_(ConditionalUNet(in_nc=3, out_nc=3, nf=dryrun.NF, depth=dryrun.DEPTH),
                        torch.Generator().manual_seed(0))


def inputs(kind) -> tuple:
    """(lq, gt) of a global batch of 2: the dry run's for the UNet, 8x8x4
    latents for the DiT."""
    if kind == "unet":
        return dryrun.make_batch(2)
    gen = torch.Generator().manual_seed(4)
    lq = torch.rand(2, 8, 8, 4, generator=gen)
    return lq, lq + 0.1 * torch.randn(lq.shape, generator=gen)


def train_state(kind, mesh=None):
    """A fresh train state (Adam, EMA) of the seeded tiny net; split over
    ``mesh``'s model group where given."""
    net = dit() if kind == "dit" else unet()
    opt = dryrun.TRAIN_OPT
    state = create_train_state(net, build_from_options(opt, net.parameters(), build_lr_schedule(opt)))
    if mesh is not None:
        tensor_parallel(state, mesh)
        data_parallel(state)
    return state


def step(state, kind, gen) -> float:
    lq, gt = inputs(kind)
    rows = dist.rows(len(lq))
    state, metrics = make_train_step(dryrun.make_sde("cpu"))(state, lq[rows], gt[rows], gen)
    return float(metrics["loss"])


def whole_state(state) -> dict:
    """The gradients, parameters and EMA, whole, on the host."""
    whole = (lambda d: d) if state.layout is None else state.layout.whole
    return {"grads": whole({k: p.grad for k, p in state.net.named_parameters()}),
            "params": whole({k: p.detach() for k, p in state.net.named_parameters()}),
            "ema": {} if state.ema is None else whole(state.ema.params)}


def one_step(kind, mesh=None) -> dict:
    state = train_state(kind, mesh)
    loss = step(state, kind, dryrun.step_generator("cpu"))
    return {"loss": loss, **whole_state(state)}


def save_dirs(root, tag) -> dict:
    return {"models": os.path.join(root, tag, "models"), "training_state": os.path.join(root, tag, "training_state")}


def resume(state, root, tag, gen) -> None:
    """The step-1 checkpoint under ``root/tag`` into ``state`` and ``gen``,
    as the train entry point resumes: ``1_G.pth`` whole, this rank's slice
    kept."""
    dirs = save_dirs(root, tag)
    sd = checkpoint.load_params(os.path.join(dirs["models"], "1_G.pth"))
    state.net.load_state_dict(sd if state.layout is None else state.layout.shard(sd))
    checkpoint.load_training_state(os.path.join(dirs["training_state"], "1.state"), state, gen)


def save_then_step(root, tag, mesh=None) -> dict:
    """Step 1, the checkpoint under ``root/tag`` (rank 0 writes), step 2:
    the losses and, whole, the state after step 2."""
    state, gen = train_state("unet", mesh), dryrun.step_generator("cpu")
    losses = [step(state, "unet", gen)]
    checkpoint.save_checkpoint(save_dirs(root, tag), state, 0, 1, gen)
    losses.append(step(state, "unet", gen))
    return {"losses": losses, **whole_state(state)}


def resume_then_step(root, tag, mesh=None) -> dict:
    """Step 2 from the checkpoint under ``root/tag``."""
    state, gen = train_state("unet", mesh), dryrun.step_generator("cpu")
    resume(state, root, tag, gen)
    return {"loss": step(state, "unet", gen), **whole_state(state)}


def refused_world() -> str:
    """make_mesh over a world that the model width does not divide."""
    try:
        make_mesh(3)
    except ValueError as e:
        return str(e)
    return ""


def tp2_ranks(device, root) -> dict:
    """Rank side of the tp2 checks: the split layers, one train step of the
    tiny DiT and of the UNet, the checkpoint round trips (the one-process
    save resumed here; a save here, which the parent resumes) and the
    refused layout."""
    refused = refused_world()
    mesh = make_mesh(2)
    out = {"refused": refused, "layers": split_layers(mesh), "dit": one_step("dit", mesh),
           "unet": one_step("unet", mesh), "resumed": resume_then_step(root, "one", mesh),
           "saved": save_then_step(root, "tp", mesh)}
    for k in ("dit", "unet", "resumed", "saved"):
        out[k] = {part: {n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v
                  for part, v in out[k].items()}
    return out


# ------------------------------------------ the NAFNet family and the compressor
FAMILY = ("nafnet", "stereo", "bokeh", "compressor", "latent")
# the tiny NAFNet: its 4-block level at 64 channels fuses (K3's plain
# version on the CPU) and is split (row convolutions from 64 channels)
NAF = {"width": 16, "enc_blk_nums": [1, 1, 4], "middle_blk_num": 1, "dec_blk_nums": [1, 1, 1]}
COMPRESSOR = {"in_ch": 3, "out_ch": 3, "ch": 16, "ch_mult": [1, 4], "embed_dim": 4}
LION = {"optimizer": "Lion", "lr_G": 3e-5, "lr_scheme": "MultiStepLR", "lr_steps": [100], "beta1": 0.9,
        "beta2": 0.99, "loss_type": "l1", "weight": 1.0, "manual_seed": 0}
SDE = {"max_sigma": 10, "T": 8, "schedule": "cosine", "eps": 0.005}
SEED = 5


def family_opt(kind) -> dict:
    """The options of a tiny train YAML of ``kind``'s task (Lion, as the
    Refusion YAMLs): ConditionalNAFNet on deraining, the stereo net on
    stereo SR (the dataset mode switches the net), the bokeh net on latents
    of a frozen compressor, the compressor itself, ConditionalNAFNet on
    latents of a frozen compressor (its fused level on an 8x8 map)."""
    opt = {"name": kind, "model": "denoising", "distortion": "derain", "sde": SDE,
           "degradation": {"sigma": 25, "noise_type": "G", "scale": 2}, "datasets": {"train": {"mode": "LQGT"}},
           "network_G": {"which_model_G": "ConditionalNAFNet", "setting": NAF}, "train": LION,
           "path": {"strict_load": True}}
    if kind == "stereo":
        opt.update(distortion="sr", datasets={"train": {"mode": "SteLQGT"}})
    elif kind == "bokeh":
        opt.update(model="latent_denoising", distortion="bokeh", datasets={"train": {"mode": "BokehLQGT"}},
                   network_G={"which_model_G": "ConditionalNAFNet", "setting": {**NAF, "img_channel": 4}},
                   network_L={"which_model": "UNet", "setting": {**COMPRESSOR, "ch": 8, "ch_mult": [1, 2]}})
    elif kind == "latent":
        opt.update(model="latent_denoising", network_G={"which_model_G": "ConditionalNAFNet",
                                                        "setting": {**NAF, "img_channel": 4}},
                   network_L={"which_model": "UNet", "setting": {**COMPRESSOR, "ch": 8, "ch_mult": [1, 2]}})
    elif kind == "compressor":
        opt.update(model="latent", network_G={"which_model_G": "UNet", "setting": COMPRESSOR})
    return options.dict_to_nonedict(copy.deepcopy(opt))


def family_task(kind, weights, mesh=None):
    """The task of ``family_opt(kind)`` (split over ``mesh``'s model group
    where given), its trained net holding ``weights`` (whole)."""
    task = runners.build_task(family_opt(kind), SEED, "cpu", mesh)
    state = task.state
    state.net.load_state_dict(weights if state.layout is None else state.layout.shard(weights))
    return task


def family_step(task, batch, gen) -> float:
    """One train step of ``task`` on ``batch`` (numpy, the global batch:
    a model group's ranks load the same rows)."""
    _, metrics = task.step(task.state, batch, gen)
    return float(metrics["loss"])


def family_one_step(kind, weights, batch, mesh=None) -> dict:
    """One step: its loss, gradients, parameters and EMA (whole), the
    split parameters' names, and each fused level's call (its input's
    shape, each block's ``conv1.weight`` shape: whole or not)."""
    from image_restoration_sde_tpu_torch.models import nafnet

    task, fused, stack = family_task(kind, weights, mesh), [], nafnet.naf_stack

    def recorded(x, blocks, *args):
        fused.append((tuple(x.shape), [tuple(b["conv1.weight"].shape) for b in blocks]))
        return stack(x, blocks, *args)

    nafnet.naf_stack = recorded
    try:
        loss = family_step(task, batch, torch.Generator().manual_seed(SEED))
    finally:
        nafnet.naf_stack = stack
    split = [] if task.state.layout is None else sorted(task.state.layout.splits)
    return {"loss": loss, **whole_state(task.state), "split": split, "fused": fused}


def family_save_then_step(root, tag, weights, batches, mesh=None) -> dict:
    """The NAFNet's step 1 on ``batches[0]``, its checkpoint under
    ``root/tag`` (Lion's moment, the EMA, the generator), step 2."""
    task, gen = family_task("nafnet", weights, mesh), torch.Generator().manual_seed(SEED)
    losses = [family_step(task, batches[0], gen)]
    checkpoint.save_checkpoint(save_dirs(root, tag), task.state, 0, 1, gen)
    losses.append(family_step(task, batches[1], gen))
    return {"losses": losses, **whole_state(task.state)}


def family_resume_then_step(root, tag, weights, batches, mesh=None) -> dict:
    """The NAFNet's step 2 from the checkpoint under ``root/tag``."""
    task, gen = family_task("nafnet", weights, mesh), torch.Generator().manual_seed(SEED)
    resume(task.state, root, tag, gen)
    return {"loss": family_step(task, batches[1], gen), **whole_state(task.state)}


def tlsc_forwards(weights, mesh=None) -> dict:
    """``CNAFNetLocal`` (the tiny NAFNet, TLSC at a 16 px train crop) on a
    16 px map, where its 4-block level fuses (the window covers the 4x4
    map), and a 32 px one, where it runs block by block (an 8x8 map, a 6x6
    window): outputs and, whole, the gradients of one cotangent each."""
    from image_restoration_sde_tpu_torch.models import build_network

    net = build_network("CNAFNetLocal", {**NAF, "train_size": [1, 3, 16, 16]})
    net.load_state_dict(weights)
    layout = None if mesh is None else parallelize(net, mesh)
    out = {}
    gen = torch.Generator().manual_seed(9)
    for hw in (16, 32):
        x, cond, cot = (torch.rand(2, hw, hw, 3, generator=gen) for _ in range(3))
        net.zero_grad()
        y = net(x, cond, torch.tensor([2.0, 6.0]))
        (y * cot).sum().backward()
        grads = {k: p.grad for k, p in net.named_parameters()}
        out[hw] = {"out": y.detach(), "grads": grads if layout is None else layout.whole(grads)}
    return out


def family_ranks(device, root, weights, batches) -> dict:
    """Rank side of ``tests/test_torch_tp_nafnet.py``: each net's tp2 step,
    the TLSC net both ways, the NAFNet's checkpoint round trips (the
    one-process save resumed here; a save here, which the parent
    resumes)."""
    mesh = make_mesh(2)
    out = {kind: family_one_step(kind, weights[kind], batches[kind][0], mesh) for kind in FAMILY}
    out["tlsc"] = tlsc_forwards(weights["tlsc"], mesh)
    out["resumed"] = family_resume_then_step(root, "one", weights["nafnet"], batches["nafnet"], mesh)
    out["saved"] = family_save_then_step(root, "tp", weights["nafnet"], batches["nafnet"], mesh)
    return _to_cpu(out)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if torch.is_tensor(tree) else tree
