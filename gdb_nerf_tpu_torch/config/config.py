"""Configuration system with the reference's exact user-facing semantics.

Behavior reproduced from the reference's configs/config.py:
  * a defaults dict merged (recursively) with the YAML file named by
    ``--cfg_file``;
  * single-level ``parent_cfg`` inheritance (the parent YAML is merged
    below the child);
  * dotted CLI overrides decoded with ``ast.literal_eval``
    (``test.eval_depth True``);
  * a ``workspace`` root (env var, with a local fallback) under which
    ``trained_model/ record/ result/`` per-task/exp directories are derived;
  * the whole tree exposed as an attribute-accessible SimpleNamespace.

Differences (deliberate, documented):
  * ``*_module`` plugin strings resolve through importlib-based registries
    (``runtime/registry.py``, ``datasets/loader.py``) rather than the
    removed-in-3.12 ``imp`` loader; the YAML keys keep the same dotted format.
  * ``gpus`` is kept but not read: the port's CLI takes ``device``.

The defaults are the JAX package's, key for key, so that one YAML file
loads to the same tree in both packages (tests/test_torch_port_host.py).
"""

from __future__ import annotations

import argparse
import copy
import os
from ast import literal_eval
from types import SimpleNamespace
from typing import Any


def decode_value(v: Any) -> Any:
    """Decode a raw string into a Python literal where possible."""
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def merge_dicts(dst: dict, src: dict) -> dict:
    """Recursively merge src into dst (src wins), in place."""
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            merge_dicts(dst[key], value)
        else:
            dst[key] = value
    return dst


def dotdictify(d: dict) -> SimpleNamespace:
    ns = SimpleNamespace(**d)
    for k, v in d.items():
        if isinstance(v, dict):
            setattr(ns, k, dotdictify(v))
    return ns


def _substitute_git_placeholders(exp_name: str) -> str:
    """Replace 'gitbranch'/'gitcommit' tokens in exp_name with the current
    branch / commit (reference configs/config.py:95-96).  The reference uses
    ``git describe --all`` with the 6-char ref-type prefix ('heads/') stripped
    and ``git describe --tags --always``; a failed git call substitutes the
    empty string, exactly like ``os.popen`` yielding no output."""
    import subprocess

    def _git(*args: str) -> str:
        try:
            out = subprocess.run(
                ["git", *args], capture_output=True, text=True, timeout=10
            ).stdout
        except (OSError, subprocess.TimeoutExpired):
            out = ""
        return out.strip().splitlines()[0].strip() if out.strip() else ""

    if "gitbranch" in exp_name:
        exp_name = exp_name.replace("gitbranch", _git("describe", "--all")[6:])
    if "gitcommit" in exp_name:
        exp_name = exp_name.replace(
            "gitcommit", _git("describe", "--tags", "--always")
        )
    return exp_name


def _workspace() -> str:
    ws = os.environ.get("workspace")
    if not ws:
        ws = os.path.join(os.getcwd(), "workspace")
    return ws


DEFAULT_CFG: dict = {
    "save_tag": "default",
    "exp_name": "default",
    "exp_name_tag": "",
    "gpus": [0],
    "distributed": False,
    "task": "",
    "resume": True,
    "ep_iter": -1,
    "save_ep": 1,
    "save_latest_ep": 1,
    "eval_ep": 1,
    "log_interval": 20,
    "save_result": False,
    "eval_lpips": True,
    "skip_eval": False,
    "fix_random": False,
    "write_video": False,
    "fps": 24,
    # model hyper-parameter sections (overridden by experiment YAMLs)
    "fpn": {
        "base_channels": 8,
        "feat_dims": [32, 16, 8],
        "feat_scales": [0.25, 0.5, 1.0],
    },
    "mvs": {
        "vol_levels": [0, 1],
        "vol_scales": [0.125, 0.5],
        "ci_scales": [1.0, 1.0],
        "voxel_dim": 8,
        "num_depth": [64, 8],
        "inv_depth": [True, False],
        "num_samples": [8],
        "loss_weight": [0.05],
    },
    "nerf": {
        "bundle_size": 2,
        "global_num_depth": 64,
        "max_num_samples": 6,
        "max_mipmap_level": 3,
        "nerf_hidden_dims": 64,
        "chunk_size": 1000000,
        "is_adaptive": False,
        "viewdir_agg": True,
        "dec_layers": 3,
        "reweighting": False,
    },
    "train": {
        "pretrain": "",
        "epoch": 10000,
        "num_workers": 8,
        "collator": "default",
        "batch_sampler": "default",
        "shuffle": True,
        "eps": 1.0e-8,
        "sampler_meta": {
            "input_views_num": [],
            "input_views_prob": [],
            "render_scale": [1.0],
            "scale_prob": [1.0],
        },
        "optim": "adam",
        "lr": 5.0e-4,
        "weight_decay": 0.0,
        "scheduler": {
            "type": "multi_step",
            "milestones": [80, 120, 200, 240],
            "gamma": 0.5,
        },
        "batch_size": 4,
    },
    "test": {
        "batch_size": 1,
        "collator": "default",
        "epoch": -1,
        "batch_sampler": "default",
        "sampler_meta": {
            "input_views_num": [],
            "input_views_prob": [],
            "render_scale": [1.0],
            "scale_prob": [1.0],
        },
        "eval_depth": False,
        "eval_center": False,
    },
    # synthetic-data escape hatch: run the pipeline without datasets on disk
    "synthetic": False,
    "synthetic_hw": [512, 640],
    # device-trace flag of the JAX package's CLI (not read by the port)
    "profile": False,
    # activation dtype for the model's feature path; geometry stays fp32
    "compute_dtype": "float32",
    # options of the JAX package's network and trainer, kept so that the
    # configs load alike; the port reads none of them (its head kernel runs
    # whenever the tensors are on the card)
    "use_pallas": False,
    "remat": False,
    "train_matmul_precision": "highest",
}


def load_cfg(cfg_file: str, opts: list[str] | None = None) -> SimpleNamespace:
    """Load a YAML config with parent inheritance + CLI overrides."""
    import yaml

    cfg = copy.deepcopy(DEFAULT_CFG)
    cfg["workspace"] = _workspace()

    with open(cfg_file, "r", encoding="utf-8") as f:
        yaml_cfg = yaml.safe_load(f) or {}

    if "parent_cfg" in yaml_cfg:
        with open(yaml_cfg["parent_cfg"], encoding="utf-8") as f:
            parent = yaml.safe_load(f) or {}
        merge_dicts(cfg, parent)
    merge_dicts(cfg, yaml_cfg)

    opts = list(opts or [])
    if len(opts) % 2 != 0:
        raise ValueError(f"Override list has odd length: {opts}")
    for i in range(0, len(opts), 2):
        keys = opts[i].split(".")
        value = decode_value(opts[i + 1])
        sub = cfg
        for key in keys[:-1]:
            sub = sub.setdefault(key, {})
        sub[keys[-1]] = value

    if not cfg.get("task"):
        raise ValueError("Task must be specified")

    if cfg.get("exp_name_tag"):
        cfg["exp_name"] += "_" + cfg["exp_name_tag"]
    cfg["exp_name"] = _substitute_git_placeholders(cfg["exp_name"])

    ws = cfg["workspace"]
    cfg["trained_model_dir"] = os.path.join(
        ws, "trained_model", cfg["task"], cfg["exp_name"]
    )
    cfg["record_dir"] = os.path.join(ws, "record", cfg["task"], cfg["exp_name"])
    cfg["result_dir"] = os.path.join(
        ws, "result", cfg["task"], cfg["exp_name"], cfg["save_tag"]
    )

    return dotdictify(cfg)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", default="configs/dtu_pretrain.yaml", type=str)
    parser.add_argument("--test", action="store_true", default=False)
    parser.add_argument("--type", type=str, default="")
    parser.add_argument("--det", type=str, default="")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def make_cfg(args: argparse.Namespace) -> SimpleNamespace:
    cfg = load_cfg(args.cfg_file, args.opts)
    cfg.local_rank = args.local_rank
    return cfg
