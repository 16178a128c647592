"""The port's checkpoint choice against the JAX package's ``load_network``.

Each case writes the same epochs twice into ``tmp_path``: as the port's
``<n>.pth`` files (torch) and as the JAX package's ``<n>.ckpt`` files
(``checkpoint.save_model``), each holding its epoch as the single weight;
both loaders must pick the same file.  Then ``run.py::load_weights`` loads
a head's state from a directory that holds only ``12.pth``, and from the
path of that file.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gdb_nerf_tpu.utils import checkpoint as jax_checkpoint
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF
from gdb_nerf_tpu_torch.run import load_weights
from gdb_nerf_tpu_torch.utils.checkpoint import load_network

LATEST = 99  # the weight held by latest.pth / latest.ckpt


def write_both(root, epochs, latest):
    """The epochs (and latest) as .pth files in root/torch and .ckpt files in
    root/jax.  Returns the two directories."""
    dirs = root / "torch", root / "jax"
    for d in dirs:
        d.mkdir()
    for e in epochs:
        torch.save({"net": {"w": torch.tensor(e)}, "epoch": e}, dirs[0] / f"{e}.pth")
        jax_checkpoint.save_model({"net": {"w": np.array(e)}}, str(dirs[1]), e)
    if latest:
        torch.save({"net": {"w": torch.tensor(LATEST)}}, dirs[0] / "latest.pth")
        jax_checkpoint.save_model({"net": {"w": np.array(LATEST)}}, str(dirs[1]), LATEST,
                                  last=True)
    return dirs


# (case, epochs on disk, latest file present, epoch asked for, file path of
# this epoch instead of the directory, the weight both loaders read)
CASES = [
    ("epoch files only", [3, 12, 7], False, -1, None, 12),
    ("latest beside them", [3, 12], True, -1, None, LATEST),
    ("explicit epoch", [3, 12], True, 3, None, 3),
    ("file path", [3, 7], False, -1, 7, 7),
]


@pytest.mark.parametrize("case, epochs, latest, epoch, file, want", CASES, ids=[c[0] for c in CASES])
def test_load_network_picks_the_file_the_jax_loader_picks(tmp_path, case, epochs, latest, epoch,
                                                          file, want):
    d_torch, d_jax = write_both(tmp_path, epochs, latest)
    if file is not None:
        d_torch, d_jax = d_torch / f"{file}.pth", d_jax / f"{file}.ckpt"
    state, path = load_network(str(d_torch), epoch)
    got_jax = jax_checkpoint.load_network(str(d_jax), epoch)
    assert int(state["w"]) == int(got_jax["w"]) == want, case
    assert os.path.basename(path) == ("latest.pth" if want == LATEST else f"{want}.pth")


def test_load_network_raises_file_not_found(tmp_path):
    """A missing directory raises FileNotFoundError in both loaders.  An
    existing directory with no checkpoint raises it in the port, where the
    JAX loader raises IndexError (``numbered[-1]`` of an empty list)."""
    with pytest.raises(FileNotFoundError):
        load_network(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        jax_checkpoint.load_network(str(tmp_path / "nope"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_network(str(tmp_path / "empty"))
    with pytest.raises(IndexError):
        jax_checkpoint.load_network(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):  # an explicit epoch that is not on disk
        load_network(str(tmp_path / "empty"), 5)


def test_load_weights_takes_the_only_epoch_file(tmp_path, capsys):
    """The CLI's loader reads ``12.pth`` from a directory that holds only it,
    and from the path of that file; without a checkpoint it keeps the
    network's weights and says so."""
    torch.manual_seed(1)
    trained = BundleNeRF(64, 16, 8)
    torch.save({"net": trained.state_dict(), "epoch": 12}, tmp_path / "12.pth")
    for where in (tmp_path, tmp_path / "12.pth"):
        torch.manual_seed(2)
        net = BundleNeRF(64, 16, 8)
        assert not torch.equal(net.lr0[0].weight, trained.lr0[0].weight)
        load_weights(net, SimpleNamespace(trained_model_dir=str(where),
                                          test=SimpleNamespace(epoch=-1)))
        assert f"[run] loaded {tmp_path / '12.pth'}" in capsys.readouterr().out
        for (k, a), b in zip(net.state_dict().items(), trained.state_dict().values()):
            assert torch.equal(a, b), k
    before = {k: v.clone() for k, v in net.state_dict().items()}
    load_weights(net, SimpleNamespace(trained_model_dir=str(tmp_path / "nope"),
                                      test=SimpleNamespace(epoch=-1)))
    assert "no checkpoint" in capsys.readouterr().out
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in before.items())
