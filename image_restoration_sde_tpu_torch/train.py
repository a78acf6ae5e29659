"""Training entry point of the PyTorch port:

    python -m image_restoration_sde_tpu_torch.train -opt=<yml> [--device cuda|cpu]

Counterpart of ``tools/train.py``: the same YAML, the same loop (print,
validate and save at their frequencies; resume from
``path.resume_state``).  The YAML's ``model`` / ``distortion`` keys select a
task runner (``runners.build_task``): the pixel tasks, the Refusion
compressor (``model: latent``) and the latent tasks (``model:
latent_denoising``, whose frozen compressor loads from
``path.pretrain_model_L``, e.g. a compressor run's ``{iter}_G.pth``).

It runs on the card unless ``--device cpu`` is given; without a card it
raises.  On the card, in one process, each train step replays one captured
CUDA graph of its forward, backward and update a step signature
(``training/captured.py``), bit-equal to the eager step; ``train(...,
capture=False)`` trains eagerly.  Data parallelism: under

    torchrun --nproc_per_node N -m image_restoration_sde_tpu_torch.train -opt=<yml> [--device cuda|cpu]

each of N processes (one a card; NCCL on the card, gloo on the CPU, or
``--dist-backend gloo`` for ranks that share a card) trains its block of
the YAML's global batch through DDP, and the run takes the one-process
steps at the global batch.  Rank 0 alone logs, validates (on the bare net,
while the others wait) and writes checkpoints; every rank resumes.

Tensor parallelism: ``train.model_parallel: M`` in the YAML (or the
environment's ``IRSDE_TP=M``) lays the N ranks out as a mesh of N / M data
rows by M model ranks (``parallel.mesh``); the M ranks of a row split the
net between them (DiT, ConditionalUNet, the NAFNet family, the
compressor; a net without a plan raises), load the
same rows and draw the same noise, and DDP averages over the rows.  Rank
0's model group validates together (the split net's forward is a
collective), and assembles the whole tensors that rank 0 writes; a
checkpoint resumes at any layout.  Ranks may share a card over gloo:

    torchrun --nproc_per_node 2 -m image_restoration_sde_tpu_torch.train -opt=<yml> --dist-backend gloo
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .data import create_dataloader, create_dataset
from .parallel import dist
from .parallel.mesh import make_mesh
from .runners import build_task, resolve_device
from .sde import rng
from .training.checkpoint import load_training_state, save_checkpoint
from .utils import options
from .utils.logging_utils import TensorboardWriter, mkdir_and_rename, mkdirs, setup_logger


def train(opt_path: str, device="cuda", backend: Optional[str] = None, capture=True):
    """Run the YAML's training to ``train.niter`` iterations; returns the
    final ``TrainState``.  Started by ``torchrun``, the process joins its
    process group (``backend``: ``parallel.dist.init``'s default by
    device) and leaves it at the end.  ``capture=False``: every step eager
    (``runners.build_task``)."""
    device = resolve_device(str(device))
    joined = not dist.is_initialized() and dist.launched()
    device = dist.init(device, backend)
    try:
        return _train(opt_path, device, capture)
    finally:
        dist.use_mesh(None)
        if joined:
            dist.shutdown()


def _train(opt_path: str, device: torch.device, capture=True):
    primary = dist.process_is_primary()
    opt = options.parse(opt_path, is_train=True)
    resume_state_path = opt["path"].get("resume_state")
    resume_iter = 0
    if resume_state_path:
        resume_iter = int(os.path.basename(resume_state_path).split(".")[0])
        options.check_resume(opt, resume_iter)
    opt = options.dict_to_nonedict(opt)

    if primary:
        if not resume_state_path:
            mkdir_and_rename(opt["path"]["experiments_root"])
        mkdirs([opt["path"][k] for k in ("models", "training_state", "log", "val_images")])
    # the other ranks log nowhere (ref train.py:95)
    setup_logger("base", opt["path"]["log"], "train_" + opt["name"], screen=primary, tofile=primary)
    setup_logger("val", opt["path"]["log"], "val_" + opt["name"], screen=primary, tofile=primary)
    logger, logger_val = logging.getLogger("base"), logging.getLogger("val")
    logger.info(options.dict2str(opt))
    tb = TensorboardWriter(os.path.join(opt["path"]["experiments_root"], "tb_logger")) \
        if primary and opt["use_tb_logger"] else None

    seed = opt["train"]["manual_seed"]
    if seed is None:
        seed = dist.broadcast(random.randint(1, 10000))
    logger.info(f"Random seed: {seed}; device {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    np.random.seed(seed)
    random.seed(seed)

    # ---------------------------------------------------------------- task
    mesh = make_mesh(options.model_parallel(opt))
    task = build_task(opt, seed, device, mesh, capture)
    logger.info(f"Task {type(task).__name__}: {task.n_params():,d} parameters")
    state = task.state
    if state.layout is not None:
        logger.info(f"Tensor parallel: mesh {mesh.shape} (data {mesh.data_size} x model {mesh.model_size}); "
                    f"{state.layout.share:.1%} of the parameter bytes split, "
                    f"{state.layout.shard_bytes(state.net) / 2**20:.1f} MiB of parameters a rank")
    task.maybe_load_pretrained(state)
    gen = rng.generator(seed, device)  # the train step's draws
    start_epoch, current_step = 0, 0
    if resume_state_path:
        start_epoch, current_step, extra = load_training_state(resume_state_path, state, gen)
        task.load_extra_state(extra)
        if current_step != resume_iter:
            raise ValueError(f"{resume_state_path} holds iteration {current_step}")
        logger.info(f"Resuming training from epoch {start_epoch}, iter {current_step}")

    # ---------------------------------------------------------------- data
    train_loader = val_loader = None
    total_iters = int(opt["train"]["niter"])
    steps_per_epoch = 1
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            train_set = create_dataset(dataset_opt)
            ratio = dataset_opt["dataset_enlarge_ratio"] or 200
            train_loader = create_dataloader(train_set, dataset_opt, opt, seed=seed, ratio=ratio,
                                             start_step=current_step)
            steps_per_epoch = train_loader.steps_per_epoch()
            logger.info(f"Train set: {len(train_set)} images, {steps_per_epoch} iters/epoch, "
                        f"target {total_iters} iters, batch {dataset_opt['batch_size']}")
            logger.info(f"Data parallel: {dist.world_size()} process(es), global batch "
                        f"{train_loader.global_batch}, per-process batch {train_loader.local_batch}")
        elif phase == "val":
            val_set = create_dataset(dataset_opt)
            val_loader = create_dataloader(val_set, dataset_opt, opt)
            logger.info(f"Val set: {len(val_set)} images")
    if train_loader is None:
        raise ValueError("the YAML has no datasets.train")

    print_freq = int(opt["logger"]["print_freq"] or 100)
    save_freq = int(opt["logger"]["save_checkpoint_freq"] or 5000)
    val_freq = int(opt["train"]["val_freq"] or 5000)
    best_psnr, best_iter = 0.0, 0
    t_last, steps_last = time.perf_counter(), current_step

    logger.info("Start training...")
    batch_iter = iter(train_loader)
    epoch = start_epoch
    try:
        while current_step < total_iters:
            batch = next(batch_iter)
            current_step += 1
            epoch = current_step // max(1, steps_per_epoch)

            state, train_metrics = task.step(state, batch, gen)

            if current_step % print_freq == 0:
                loss = float(train_metrics["loss"])
                now = time.perf_counter()
                bsz = len(next(iter(batch.values()))) * dist.data_size()
                ips = (current_step - steps_last) * bsz / (now - t_last)
                t_last, steps_last = now, current_step
                lr = float(task.lr_schedule(current_step))
                logger.info(f"<epoch:{epoch:3d}, iter:{current_step:8,d}, lr:{lr:.3e}, "
                            f"img/s:{ips:.1f}> loss: {loss:.8e}")
                if tb:
                    tb.add_scalar("loss", loss, current_step)
                    tb.add_scalar("img_per_sec", ips, current_step)

            if val_loader is not None and current_step % val_freq == 0:
                # rank 0 alone, on the bare net (with the rest of its model
                # group where the net is split: its forward is theirs); the
                # others wait, then take its degradation generator, which
                # the validation drew from as one process's would
                if dist.data_rank() == 0:
                    vm = task.validate(state, val_loader, rng.generator(seed + current_step, device),
                                       opt["path"]["val_images"], current_step)
                if primary:
                    if vm["psnr"] > best_psnr:
                        best_psnr, best_iter = vm["psnr"], current_step
                    logger_val.info(f"<epoch:{epoch:3d}, iter:{current_step:8,d}, psnr: {vm['psnr']:.6f}, "
                                    f"best psnr: {best_psnr:.6f} @ iter {best_iter:,d}>")
                    if tb:
                        tb.add_scalar("val_psnr", vm["psnr"], current_step)
                task.load_extra_state(dist.broadcast(task.extra_state()))

            if current_step % save_freq == 0:
                logger.info("Saving models and training states.")
                save_checkpoint(opt["path"], state, epoch, current_step, gen, task.extra_state())
    finally:
        batch_iter.close()  # stop the prefetch thread
    if current_step % save_freq:  # else the last save point wrote this very state
        logger.info("Saving the final model.")
        save_checkpoint(opt["path"], state, epoch, current_step, gen, task.extra_state())
    logger.info("End of training.")
    if tb:
        tb.close()
    return state


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where to train (default: the card)")
    parser.add_argument("--dist-backend", default=None, choices=dist.BACKENDS,
                        help="under torchrun: the process group's backend (default: nccl on the card, gloo on the "
                             "CPU; gloo lets ranks share a card)")
    args = parser.parse_args(argv)
    train(args.opt, args.device, args.dist_backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
