"""YAML option parsing with reference-compatible semantics.

A copy of ``image_restoration_sde_tpu/utils/options.py``; it differs only
in ``check_resume``, which points at the port's ``{iter}_G.pth``.

Parity target: ``codes/config/<task>/options.py`` — the same YAML schema
(name/model/distortion/gpu_ids, sde{...}, degradation{...}, datasets{...},
network_G{which_model[,_G], setting}, [network_L], path{...}, train{...},
logger{...}) parses into the same nested-dict shape with ``NoneDict``
missing-key behavior, so reference option files run unchanged.

Deltas by design:
- ``gpu_ids`` does not set CUDA_VISIBLE_DEVICES; it is kept only so old
  YAMLs load.  The train entry point takes its device from ``--device``.
- experiment/result roots default under the current working directory's
  ``experiments/<task>/<name>`` rather than a hardcoded repo-relative path;
  ``path.root`` in the YAML overrides.
- ``check_resume`` rewires ``pretrain_model_G`` to ``{iter}_G.pth``, the
  reference's name, which ``training.checkpoint`` writes.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional

import yaml


class NoneDict(dict):
    """dict returning None for missing keys (ref options.py:104-106)."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    """Recursively wrap dicts as NoneDict (ref options.py:110-118)."""
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def model_parallel(opt) -> int:
    """The tensor-parallel width of a train run: the environment's
    ``IRSDE_TP``, else the YAML's ``train.model_parallel``, else 1 (as
    ``tools/train.py`` reads it)."""
    return int(os.environ.get("IRSDE_TP") or ((opt["train"] or {}).get("model_parallel") or 1)) or 1


def dict2str(opt, indent_l: int = 1) -> str:
    """Pretty nested-dict printer for logs (ref options.py:91-100)."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg


def parse(
    opt_path: str,
    is_train: bool = True,
    root: Optional[str] = None,
    task: Optional[str] = None,
) -> Dict[str, Any]:
    """Parse a reference-format option YAML (ref options.py:18-88).

    ``task`` names the experiment subdirectory (the reference derives it
    from the config file's parent directory name); defaults to the YAML
    file's grandparent directory name or 'default'.
    """
    with open(opt_path, "r") as f:
        opt = yaml.safe_load(f)

    opt["is_train"] = is_train

    # sr tasks propagate scale into the network settings (ref options.py:28-34)
    scale = 1
    if opt.get("distortion") == "sr":
        scale = opt["degradation"]["scale"]
        opt.setdefault("network_G", {}).setdefault("setting", {})["upscale"] = scale

    # datasets: phase/scale/data_type inference (ref options.py:37-57)
    for phase, dataset in (opt.get("datasets") or {}).items():
        if dataset is None:
            continue
        dataset["phase"] = phase.split("_")[0]
        dataset["scale"] = scale
        is_lmdb = False
        for k in ("dataroot_GT", "dataroot_LQ"):
            if dataset.get(k):
                dataset[k] = osp.expanduser(dataset[k])
                if dataset[k].endswith("lmdb"):
                    is_lmdb = True
        dataset["data_type"] = "lmdb" if is_lmdb else "img"
        if dataset.get("mode", "").endswith("_mc"):
            dataset["data_type"] = "mc"
            dataset["mode"] = dataset["mode"].replace("_mc", "")

    # path section (ref options.py:59-87)
    opt.setdefault("path", {})
    for key, p in list(opt["path"].items()):
        if p and key != "strict_load":
            opt["path"][key] = osp.expanduser(str(p))
    if root is None:
        root = opt["path"].get("root") or os.getcwd()
    opt["path"]["root"] = osp.abspath(root)
    if task is None:
        parts = osp.abspath(opt_path).split(os.sep)
        # configs/<task>/{train,test}/file.yml -> <task>
        task = parts[-3] if len(parts) >= 3 else "default"
    opt["task"] = task

    if is_train:
        experiments_root = osp.join(opt["path"]["root"], "experiments", task, opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_state"] = osp.join(experiments_root, "training_state")
        opt["path"]["log"] = experiments_root
        opt["path"]["val_images"] = osp.join(experiments_root, "val_images")
        if "debug" in opt["name"]:
            opt.setdefault("train", {})["val_freq"] = 8
            opt.setdefault("logger", {})["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(opt["path"]["root"], "results", task)
        opt["path"]["results_root"] = osp.join(results_root, opt["name"])
        opt["path"]["log"] = osp.join(results_root, opt["name"])

    return opt


def check_resume(opt: Dict[str, Any], resume_iter: int) -> None:
    """Rewire pretrain_model_G to the resume checkpoint (ref options.py:122-142).
    Every task loads it on resume, the compressor's included; a latent
    task's ``pretrain_model_L`` (its frozen compressor) stays as given."""
    if opt["path"].get("resume_state"):
        opt["path"]["pretrain_model_G"] = osp.join(
            opt["path"]["models"], f"{resume_iter}_G.pth"
        )


def network_setting(opt: Dict[str, Any], key: str = "network_G") -> tuple:
    """Extract (which_model, setting) accepting both ``which_model`` and
    ``which_model_G`` spellings found across reference configs."""
    net_opt = opt[key]
    which = net_opt.get("which_model") or net_opt.get("which_model_G") or net_opt.get("which_model_L")
    setting = dict(net_opt.get("setting") or {})
    return which, setting
