"""Generate the per-task option-file library under ``configs/``:

    python -m image_restoration_sde_tpu_torch.gen_configs [--out DIR]

Counterpart of ``tools/gen_configs.py``: the same specs, written to the
same file names with the same bytes.  One spec dict per reference task
(the 11 task directories of the upstream repository), emitted in the
reference YAML schema so the files stay interchangeable with the upstream
ones (values follow the published training budgets; dataroots are
placeholders the user points at their datasets).  ``--out`` defaults to
the repository's ``configs/``, which it overwrites file by file; the
YAMLs it does not generate (the DiT, the demos) are left as they are.
"""

from __future__ import annotations

import argparse
import os
import sys

import yaml

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

UNET = {"which_model_G": "ConditionalUNet",
        "setting": {"in_nc": 3, "out_nc": 3, "nf": 64, "depth": 4}}
NAF = {"which_model_G": "ConditionalNAFNet",
       "setting": {"width": 64, "enc_blk_nums": [1, 1, 1, 28],
                   "middle_blk_num": 1, "dec_blk_nums": [1, 1, 1, 1]}}


def train_block(optimizer="Adam", lr=1e-4, scheme="MultiStepLR", niter=700000,
                val_freq=5e3, is_weighted=False):
    return {
        "optimizer": optimizer, "lr_G": lr, "lr_scheme": scheme,
        "beta1": 0.9, "beta2": 0.99, "niter": niter, "warmup_iter": -1,
        "lr_steps": [200000, 400000, 600000], "lr_gamma": 0.5,
        "eta_min": 1e-7, "is_weighted": is_weighted, "loss_type": "l1",
        "weight": 1.0, "manual_seed": 0, "val_freq": val_freq,
    }


def dataset(mode, gt, lq=None, gt_size=128, lr_size=128, batch=4, extra=None):
    d = {"name": "Train_Dataset", "mode": mode, "dataroot_GT": gt}
    if lq:
        d["dataroot_LQ"] = lq
    d.update({"use_shuffle": True, "n_workers": 8, "batch_size": batch,
              "GT_size": gt_size, "use_flip": True, "use_rot": True, "color": "RGB"})
    if lr_size is not None:
        d["LR_size"] = lr_size
    if extra:
        d.update(extra)
    return d


def val_dataset(mode, gt, lq=None, extra=None):
    d = {"name": "Val_Dataset", "mode": mode, "dataroot_GT": gt}
    if lq:
        d["dataroot_LQ"] = lq
    d["max_images"] = 16
    if extra:
        d.update(extra)
    return d


def base(name, model, distortion, sde, net, train, tr_ds, va_ds, extra=None):
    opt = {
        "name": name, "use_tb_logger": True, "model": model,
        "distortion": distortion, "gpu_ids": [0],
        "sde": sde,
        "degradation": {"sigma": 25, "noise_type": "G", "scale": 4},
        "datasets": {"train": tr_ds, "val": va_ds},
        "network_G": net,
        "path": {"pretrain_model_G": None, "strict_load": True, "resume_state": None},
        "train": train,
        "logger": {"print_freq": 100, "save_checkpoint_freq": 5e3},
    }
    if extra:
        for k, v in extra.items():
            if isinstance(v, dict) and k in opt:
                opt[k].update(v)
            else:
                opt[k] = v
    return opt


def test_cfg(name, model, distortion, sde, net, test_ds, extra=None):
    opt = {
        "name": name, "suffix": None, "model": model, "distortion": distortion,
        "gpu_ids": [0], "sde": dict(sde, sampling_mode="posterior"),
        "degradation": {"sigma": 25, "noise_type": "G", "scale": 4},
        "datasets": {"test1": test_ds},
        "network_G": net,
        "path": {"pretrain_model_G": "pretrained/model_G"},
    }
    if extra:
        for k, v in extra.items():
            if isinstance(v, dict) and k in opt:
                opt[k].update(v)
            else:
                opt[k] = v
    return opt


SDE100 = lambda ms: {"max_sigma": ms, "T": 100, "schedule": "cosine", "eps": 0.005}

CONFIGS = {}

# ------------------------------------------------------------ pixel tasks
CONFIGS["deraining/train/ir-sde.yml"] = base(
    "ir-sde", "denoising", "derain", SDE100(10), UNET,
    train_block("Adam", 1e-4, "MultiStepLR", 700000),
    dataset("LQGT", "datasets/rain/trainH/GT", "datasets/rain/trainH/LQ"),
    val_dataset("LQGT", "datasets/rain/testH/GT", "datasets/rain/testH/LQ"))
CONFIGS["deraining/train/refusion.yml"] = base(
    "refusion", "denoising", "derain", SDE100(50), NAF,
    train_block("Lion", 3e-5, "TrueCosineAnnealingLR", 500000),
    dataset("LQGT", "datasets/rain/trainH/GT", "datasets/rain/trainH/LQ"),
    val_dataset("LQGT", "datasets/rain/testH/GT", "datasets/rain/testH/LQ"))
CONFIGS["deraining/test/ir-sde.yml"] = test_cfg(
    "ir-sde-posterior", "denoising", "derain", SDE100(10), UNET,
    {"name": "Rain100H", "mode": "LQGT",
     "dataroot_GT": "datasets/Rain100H/GT", "dataroot_LQ": "datasets/Rain100H/LQ"})
CONFIGS["deraining/test/refusion.yml"] = test_cfg(
    "refusion", "denoising", "derain", SDE100(50), NAF,
    {"name": "Rain100H", "mode": "LQGT",
     "dataroot_GT": "datasets/Rain100H/GT", "dataroot_LQ": "datasets/Rain100H/LQ"})

CONFIGS["deblurring/train/ir-sde.yml"] = base(
    "ir-sde", "denoising", "deblur", SDE100(10), UNET,
    train_block("Adam", 1e-4, "MultiStepLR", 700000),
    dataset("LQGT", "datasets/gopro/train/GT", "datasets/gopro/train/LQ"),
    val_dataset("LQGT", "datasets/gopro/test/GT", "datasets/gopro/test/LQ"))
CONFIGS["deblurring/train/refusion.yml"] = base(
    "refusion", "denoising", "deblur", SDE100(50), NAF,
    train_block("Lion", 4e-5, "TrueCosineAnnealingLR", 700000),
    dataset("LQGT", "datasets/gopro/train/GT", "datasets/gopro/train/LQ"),
    val_dataset("LQGT", "datasets/gopro/test/GT", "datasets/gopro/test/LQ"))
CONFIGS["deblurring/test/refusion.yml"] = test_cfg(
    "refusion", "denoising", "deblur", SDE100(50), NAF,
    {"name": "GoPro", "mode": "LQGT",
     "dataroot_GT": "datasets/gopro/test/GT", "dataroot_LQ": "datasets/gopro/test/LQ"})
CONFIGS["deblurring/test/ir-sde.yml"] = test_cfg(
    "ir-sde", "denoising", "deblur", SDE100(10), UNET,
    {"name": "GoPro", "mode": "LQGT",
     "dataroot_GT": "datasets/gopro/test/GT", "dataroot_LQ": "datasets/gopro/test/LQ"})

CONFIGS["deshadow/train/refusion.yml"] = base(
    "refusion", "denoising", "deshadow", SDE100(50), NAF,
    train_block("Lion", 4e-5, "TrueCosineAnnealingLR", 500000),
    dataset("LQGT", "datasets/shadow/train/GT", "datasets/shadow/train/LQ"),
    val_dataset("LQGT", "datasets/shadow/val/GT", "datasets/shadow/val/LQ"))
CONFIGS["deshadow/train/ir-sde.yml"] = base(
    "ir-sde", "denoising", "deshadow", SDE100(10), UNET,
    train_block("Adam", 1e-4, "MultiStepLR", 700000),
    dataset("LQGT", "datasets/shadow/train/GT", "datasets/shadow/train/LQ"),
    val_dataset("LQGT", "datasets/shadow/val/GT", "datasets/shadow/val/LQ"))
# ref deshadow/options/test/ir-sde.yml ships a smaller deeper net (nf 32, depth 5)
CONFIGS["deshadow/test/ir-sde.yml"] = test_cfg(
    "ir-sde", "denoising", "deshadow",
    {"max_sigma": 30, "T": 100, "schedule": "cosine", "eps": 0.005},
    {"which_model_G": "ConditionalUNet",
     "setting": {"in_nc": 3, "out_nc": 3, "nf": 32, "depth": 5}},
    {"name": "NTIRE23-Shadow", "mode": "LQGT",
     "dataroot_GT": "datasets/shadow/val/GT", "dataroot_LQ": "datasets/shadow/val/LQ"})
CONFIGS["deshadow/test/refusion.yml"] = test_cfg(
    "refusion", "denoising", "deshadow", SDE100(50), NAF,
    {"name": "NTIRE23-Shadow", "mode": "LQGT",
     "dataroot_GT": "datasets/shadow/val/GT", "dataroot_LQ": "datasets/shadow/val/LQ"})

CONFIGS["inpainting/train/ir-sde.yml"] = base(
    "ir-sde", "denoising", "inpainting", SDE100(30), UNET,
    train_block("Adam", 1e-4, "MultiStepLR", 700000),
    dataset("GT", "datasets/celebaHQ/trainHQ", lr_size=None),
    val_dataset("GT", "datasets/celebaHQ/testHQ"),
    extra={"degradation": {"mask_root": "datasets/gt_keep_masks/thin"}})
CONFIGS["inpainting/test/ir-sde.yml"] = test_cfg(
    "ir-sde", "denoising", "inpainting", SDE100(30), UNET,
    {"name": "CelebaHQ", "mode": "GT", "dataroot_GT": "datasets/celebaHQ/testHQ"},
    extra={"degradation": {"mask_root": "datasets/gt_keep_masks/thin"}})

CONFIGS["inpainting/train/refusion.yml"] = base(
    "refusion", "denoising", "inpainting", SDE100(50), NAF,
    train_block("Lion", 4e-5, "TrueCosineAnnealingLR", 700000),
    dataset("GT", "datasets/celebaHQ/trainHQ", lr_size=None),
    val_dataset("GT", "datasets/celebaHQ/testHQ"),
    extra={"degradation": {"mask_root": "datasets/gt_keep_masks/thin"}})
CONFIGS["inpainting/test/refusion.yml"] = test_cfg(
    "refusion", "denoising", "inpainting", SDE100(50), NAF,
    {"name": "CelebaHQ", "mode": "GT", "dataroot_GT": "datasets/celebaHQ/testHQ"},
    extra={"degradation": {"mask_root": "datasets/gt_keep_masks/thin"}})

CONFIGS["sisr/train/ir-sde.yml"] = base(
    "ir-sde", "denoising", "sr", SDE100(30), UNET,
    train_block("Adam", 1e-4, "MultiStepLR", 700000),
    dataset("LQGT", "datasets/DF2K/HR", "datasets/DF2K/LR_x4", gt_size=128, lr_size=32),
    val_dataset("LQGT", "datasets/Set5/HR", "datasets/Set5/LRbicx4"))
CONFIGS["sisr/test/ir-sde.yml"] = test_cfg(
    "ir-sde", "denoising", "sr", SDE100(30), UNET,
    {"name": "Set5", "mode": "LQGT",
     "dataroot_GT": "datasets/Set5/HR", "dataroot_LQ": "datasets/Set5/LRbicx4"},
    extra={"crop_border": 4})

CONFIGS["sisr/train/refusion.yml"] = base(
    "refusion", "denoising", "sr", SDE100(50), NAF,
    train_block("Lion", 4e-5, "TrueCosineAnnealingLR", 700000),
    dataset("LQGT", "datasets/DF2K/HR", "datasets/DF2K/LR_x4", gt_size=128, lr_size=32),
    val_dataset("LQGT", "datasets/Set5/HR", "datasets/Set5/LRbicx4"))
CONFIGS["sisr/test/refusion.yml"] = test_cfg(
    "refusion", "denoising", "sr", SDE100(50), NAF,
    {"name": "Set5", "mode": "LQGT",
     "dataroot_GT": "datasets/Set5/HR", "dataroot_LQ": "datasets/Set5/LRbicx4"},
    extra={"crop_border": 4})

CONFIGS["denoising/train/ir-sde.yml"] = base(
    "ir-sde", "denoising", "denoising",
    {"max_sigma": 70, "T": 1000, "schedule": "cosine"}, UNET,
    train_block("Adam", 1e-4, "MultiStepLR", 700000, is_weighted=True),
    dataset("GT", "datasets/trainHR", lr_size=None, batch=8),
    val_dataset("GT", "datasets/McMaster"),
    extra={"degradation": {"sigma": 50}})
CONFIGS["denoising/test/ir-sde.yml"] = test_cfg(
    "ir-sde", "denoising", "denoising",
    {"max_sigma": 70, "T": 1000, "schedule": "cosine"}, UNET,
    {"name": "McMaster", "mode": "GT", "dataroot_GT": "datasets/McMaster"},
    extra={"degradation": {"sigma": 50}})

CONFIGS["denoising/train/refusion.yml"] = base(
    "refusion", "denoising", "denoising",
    {"max_sigma": 70, "T": 1000, "schedule": "cosine"}, NAF,
    train_block("Lion", 3e-5, "TrueCosineAnnealingLR", 700000, val_freq=1e4),
    dataset("GT", "datasets/trainHR", lr_size=None, batch=8),
    val_dataset("GT", "datasets/McMaster"),
    extra={"degradation": {"sigma": 50},
           "train": {"eta_min": 1e-6},
           "logger": {"print_freq": 200, "save_checkpoint_freq": 1e4}})
CONFIGS["denoising/test/refusion.yml"] = test_cfg(
    "refusion", "denoising", "denoising",
    {"max_sigma": 70, "T": 1000, "schedule": "cosine"}, NAF,
    {"name": "McMaster", "mode": "GT", "dataroot_GT": "datasets/McMaster"},
    extra={"degradation": {"sigma": 15}})

CONFIGS["stereo-sr/train/refusion.yml"] = base(
    "refusion-ssr", "denoising", "sr", SDE100(50), NAF,
    train_block("Lion", 3e-5, "TrueCosineAnnealingLR", 600000, val_freq=1e4),
    dataset("SteLQGT", "datasets/stereo-sr/train/HR", "datasets/stereo-sr/train/LR_x4",
            gt_size=128, lr_size=32, batch=8),
    val_dataset("SteLQGT", "datasets/stereo-sr/val/HR", "datasets/stereo-sr/val/LR_x4"))
CONFIGS["stereo-sr/test/refusion.yml"] = test_cfg(
    "refusion-ssr", "denoising", "sr", SDE100(50), NAF,
    {"name": "Flickr1024", "mode": "SteLQGT",
     "dataroot_GT": "datasets/stereo-sr/val/HR", "dataroot_LQ": "datasets/stereo-sr/val/LR_x4"})

# ------------------------------------------------------------ latent tasks
COMPRESSOR_HAZE = {"which_model_G": "UNet",
                   "setting": {"in_ch": 3, "out_ch": 3, "ch": 8,
                               "ch_mult": [4, 8, 8, 16], "embed_dim": 8}}
COMPRESSOR_BOKEH = {"which_model_G": "UNet",
                    "setting": {"in_ch": 3, "out_ch": 3, "ch": 64,
                                "ch_mult": [1, 2, 4], "embed_dim": 4}}

CONFIGS["unet-latent/train/train_haze.yml"] = base(
    "latent_haze", "latent", "dehazing", SDE100(50), COMPRESSOR_HAZE,
    train_block("Lion", 3e-5, "TrueCosineAnnealingLR", 300000),
    dataset("LQGT", "datasets/dehazing/train/GT", "datasets/dehazing/train/LQ",
            gt_size=256, lr_size=256, batch=16, extra={"use_swap": True}),
    val_dataset("LQGT", "datasets/dehazing/val/GT", "datasets/dehazing/val/LQ"))
CONFIGS["unet-latent/train/train_bokeh.yml"] = base(
    "latent_bokeh", "latent", "bokeh", SDE100(50), COMPRESSOR_BOKEH,
    train_block("Lion", 3e-5, "TrueCosineAnnealingLR", 300000),
    dataset("LQGT", "datasets/bokeh/train/tgt", "datasets/bokeh/train/src",
            gt_size=256, lr_size=256, batch=16, extra={"use_swap": True}),
    val_dataset("LQGT", "datasets/bokeh/val/tgt", "datasets/bokeh/val/src"))
CONFIGS["unet-latent/test/test_latent.yml"] = test_cfg(
    "latent_haze", "latent", "dehazing", SDE100(50), COMPRESSOR_HAZE,
    {"name": "HazeVal", "mode": "LQGT",
     "dataroot_GT": "datasets/dehazing/val/GT", "dataroot_LQ": "datasets/dehazing/val/LQ"},
    extra={"path": {"pretrain_model_G": "pretrained/latent_haze_G"}})

NAF_LATENT = {"which_model": "ConditionalNAFNet",
              "setting": {"img_channel": 8, "width": 64, "enc_blk_nums": [1, 1, 1, 28],
                          "middle_blk_num": 1, "dec_blk_nums": [1, 1, 1, 1]}}
CONFIGS["latent-dehazing/train/nasde.yml"] = base(
    "latent-refusion-dehazing", "latent_denoising", "dehazing",
    dict(SDE100(50), sample_T=100), NAF_LATENT,
    train_block("Lion", 3e-5, "TrueCosineAnnealingLR", 400000, val_freq=1e4),
    dataset("LQGT", "datasets/dehazing/train/GT_sub", "datasets/dehazing/train/LQ_sub",
            gt_size=1024, lr_size=1024, batch=8, extra={"use_swap": False}),
    val_dataset("LQGT", "datasets/dehazing/val/GT", "datasets/dehazing/val/LQ"),
    extra={"network_L": {"which_model": "UNet",
                         "setting": {"in_ch": 3, "out_ch": 3, "ch": 8,
                                     "ch_mult": [4, 8, 8, 16], "embed_dim": 8}},
           "path": {"pretrain_model_L": "pretrained/latent-dehazing-L"},
           "logger": {"print_freq": 200, "save_checkpoint_freq": 1e4}})
CONFIGS["latent-dehazing/test/nasde.yml"] = test_cfg(
    "latent-refusion-dehazing", "latent_denoising", "dehazing",
    dict(SDE100(50), sample_T=100), NAF_LATENT,
    {"name": "HazeVal", "mode": "LQGT",
     "dataroot_GT": "datasets/dehazing/val/GT", "dataroot_LQ": "datasets/dehazing/val/LQ"},
    extra={"network_L": {"which_model": "UNet",
                         "setting": {"in_ch": 3, "out_ch": 3, "ch": 8,
                                     "ch_mult": [4, 8, 8, 16], "embed_dim": 8}},
           "path": {"pretrain_model_L": "pretrained/latent-dehazing-L"}})

NAF_BOKEH = {"which_model": "ConditionalNAFNet",
             "setting": {"img_channel": 4, "width": 64, "enc_blk_nums": [2, 2, 4, 8],
                         "middle_blk_num": 12, "dec_blk_nums": [2, 2, 2, 2]}}
BOKEH_DS_EXTRA = {"dataroot_alpha": "datasets/bokeh/train/alpha",
                  "dataroot_meta": "datasets/bokeh/train/meta.txt", "use_swap": False}
CONFIGS["latent-bokeh/train/refusion.yml"] = base(
    "latent-refusion-bokeh", "latent_denoising", "bokeh", SDE100(50), NAF_BOKEH,
    train_block("Lion", 3e-5, "TrueCosineAnnealingLR", 1000000, val_freq=1e4),
    dataset("BokehLQGT", "datasets/bokeh/train/tgt", "datasets/bokeh/train/src",
            gt_size=512, lr_size=512, batch=8, extra=BOKEH_DS_EXTRA),
    val_dataset("BokehLQGT", "datasets/bokeh/val/tgt", "datasets/bokeh/val/src",
                extra={"dataroot_alpha": "datasets/bokeh/val/alpha",
                       "dataroot_meta": "datasets/bokeh/val/meta.txt"}),
    extra={"network_L": {"which_model": "UNet",
                         "setting": {"in_ch": 3, "out_ch": 3, "ch": 64,
                                     "ch_mult": [1, 2, 4], "embed_dim": 4}},
           "path": {"pretrain_model_L": "pretrained/latent-bokeh-L"},
           "logger": {"print_freq": 200, "save_checkpoint_freq": 1e4}})


CONFIGS["latent-bokeh/test/refusion.yml"] = test_cfg(
    "latent-refusion-bokeh", "latent_denoising", "bokeh", SDE100(50), NAF_BOKEH,
    {"name": "NTIRE23-Bokeh", "mode": "BokehLQ",
     "dataroot_LQ": "datasets/bokeh/val/src",
     "dataroot_meta": "datasets/bokeh/val/meta.txt"},
    extra={"network_L": {"which_model": "UNet",
                         "setting": {"in_ch": 3, "out_ch": 3, "ch": 64,
                                     "ch_mult": [1, 2, 4], "embed_dim": 4}},
           "path": {"pretrain_model_G": "pretrained/latent-bokeh_G",
                    "pretrain_model_L": "pretrained/latent-bokeh-L"}})


def write(out: str = ROOT) -> int:
    """Every file of CONFIGS under ``out``; returns their count."""
    for rel, cfg in CONFIGS.items():
        path = os.path.join(out, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False, default_flow_style=None)
    return len(CONFIGS)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=ROOT, help="where the task directories go (default: the repository's configs/)")
    args = p.parse_args(argv)
    print(f"wrote {write(args.out)} configs under {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
