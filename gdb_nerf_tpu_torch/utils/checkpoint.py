"""Checkpoint files of the reference's ``.pth`` contract.

A checkpoint is ``{'net': state_dict, ...}`` (a bare state dict loads too),
named ``<epoch>.pth`` or ``latest.pth`` inside a model directory.  The
choice of file follows the JAX package's ``utils/checkpoint.py::load_network``
(there with ``.ckpt`` names).  Saving, resuming and ``load_pretrain`` come
with the training path.
"""

from __future__ import annotations

import os

import torch


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
        numbered = sorted(int(f[:-4]) for f in files if f.endswith(".pth") and f[:-4].isdigit())
        if "latest.pth" in files:
            path = os.path.join(model_dir, "latest.pth")
        elif numbered:
            path = os.path.join(model_dir, f"{numbered[-1]}.pth")
        else:
            raise FileNotFoundError(f"No checkpoint in {model_dir}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob.get("net", blob), path
