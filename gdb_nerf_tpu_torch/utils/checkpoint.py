"""Checkpoint files of the reference's ``.pth`` contract.

A checkpoint is ``{'net': state_dict, 'optim', 'scheduler', 'recorder',
'epoch', 'step'}`` (a bare state dict loads too), named ``<epoch>.pth`` or
``latest.pth`` inside a model directory; at most 100 numbered files are
kept.  Port of ``gdb_nerf_tpu/utils/checkpoint.py`` (there msgpack files
named ``.ckpt``): the same choice of file for resuming (``load_model``),
for eval (``load_network``) and for a warm start from another experiment
(``load_pretrain``).
"""

from __future__ import annotations

import os
import shutil

import torch

MAX_NUMBERED = 100


def _numbered(files) -> list[int]:
    return sorted(int(f[:-4]) for f in files if f.endswith(".pth") and f[:-4].isdigit())


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_model(state: dict, model_dir: str, epoch: int, last: bool = False) -> None:
    """Write ``state`` with its epoch to ``latest.pth`` (``last``) or
    ``<epoch>.pth``, through a ``.tmp`` file and a rename; then remove the
    oldest numbered file while more than 100 are left."""
    os.makedirs(model_dir, exist_ok=True)
    name = "latest.pth" if last else f"{epoch}.pth"
    tmp = os.path.join(model_dir, name + ".tmp")
    torch.save(dict(state, epoch=epoch), tmp)
    os.replace(tmp, os.path.join(model_dir, name))
    epochs = _numbered(os.listdir(model_dir))
    while len(epochs) > MAX_NUMBERED:
        os.remove(os.path.join(model_dir, f"{epochs.pop(0)}.pth"))


def load_model(model_dir: str, resume: bool = True, epoch: int = -1):
    """The full training state to resume from, and the epoch to begin at:
    ``(state, state['epoch'] + 1)``, or ``(None, 0)`` when there is nothing to
    resume.  ``resume=False`` deletes ``model_dir`` first.  With ``epoch ==
    -1`` the file is ``latest.pth`` if present, else the highest-numbered
    ``<n>.pth``; else ``<epoch>.pth``."""
    if not resume and os.path.exists(model_dir):
        shutil.rmtree(model_dir)
    if not os.path.exists(model_dir):
        return None, 0
    files = os.listdir(model_dir)
    numbered = _numbered(files)
    if epoch != -1:
        path = os.path.join(model_dir, f"{epoch}.pth")
    elif "latest.pth" in files:
        path = os.path.join(model_dir, "latest.pth")
    elif numbered:
        path = os.path.join(model_dir, f"{numbered[-1]}.pth")
    else:
        return None, 0
    state = _read(path)
    print(f"Resuming from {path} (epoch {state['epoch']})")
    return state, int(state["epoch"]) + 1


def load_network(model_dir: str, epoch: int = -1) -> tuple[dict, str]:
    """The network's state dict and the path of the file it came from:
    ``model_dir`` itself if it is a file; else ``<epoch>.pth`` in it, or for
    ``epoch == -1`` ``latest.pth`` if present, else the highest-numbered
    ``<n>.pth``.  Raises FileNotFoundError when there is no such file (a
    missing directory, one with no checkpoint, a missing ``<epoch>.pth``)."""
    if os.path.isfile(model_dir):
        path = model_dir
    elif not os.path.isdir(model_dir):
        raise FileNotFoundError(f"No checkpoint dir: {model_dir}")
    elif epoch != -1:
        path = os.path.join(model_dir, f"{epoch}.pth")
    else:
        files = set(os.listdir(model_dir))
        numbered = _numbered(files)
        if "latest.pth" in files:
            path = os.path.join(model_dir, "latest.pth")
        elif numbered:
            path = os.path.join(model_dir, f"{numbered[-1]}.pth")
        else:
            raise FileNotFoundError(f"No checkpoint in {model_dir}")
    blob = _read(path)
    return blob.get("net", blob), path


def load_pretrain(cfg) -> dict | None:
    """The network state of another experiment's ``latest.pth``
    (``<workspace>/trained_model/<task>/<train.pretrain>/``) to warm-start
    from, or None (no ``train.pretrain``, or no such file)."""
    if not cfg.train.pretrain:
        return None
    path = os.path.join(cfg.workspace, "trained_model", cfg.task, cfg.train.pretrain,
                        "latest.pth")
    if not os.path.exists(path):
        print(f"[pretrain] no checkpoint at {path}; starting from scratch")
        return None
    print(f"Warm-starting from {path}")
    blob = _read(path)
    return blob.get("net", blob)
