"""Weights carried across: the JAX variable tree back to the port's state dict.

The golden fixture's 205 reference tensors (``sd/*``) go through the repo's
torch -> JAX converter (tools/convert_checkpoint.py::convert) and back
through ``state_dict_from_jax``; every tensor must come back bit-exactly,
and the port's Network must load the result with strict=True.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from gdb_nerf_tpu_torch.models.network import Network
from gdb_nerf_tpu_torch.utils.convert import state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_checkpoint import convert  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dtu_eval_golden.npz")


@pytest.fixture(scope="module")
def golden_sd():
    g = np.load(GOLDEN)
    kw = json.loads(bytes(g["meta/convert_kw"]).decode())
    return {k[3:]: np.array(g[k]) for k in g.files if k.startswith("sd/")}, kw


def test_golden_state_dict_round_trip_is_bit_exact(golden_sd):
    sd, kw = golden_sd
    kw["stage_feat_dims"] = tuple(kw["stage_feat_dims"])
    tree = convert(sd, strict=True, **kw)
    back = state_dict_from_jax(tree, num_stages=kw["num_stages"], dec_layers=kw["dec_layers"])
    assert len(sd) == 205
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        got = back[k].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_port_network_loads_round_tripped_weights_strictly(golden_sd):
    sd, kw = golden_sd
    kw["stage_feat_dims"] = tuple(kw["stage_feat_dims"])
    back = state_dict_from_jax(convert(sd, **kw), num_stages=2, dec_layers=3)
    net = Network(mvs_num_depth=(64, 8), max_num_samples=3, is_adaptive=True)
    net.load_state_dict(back, strict=True)
    own = net.state_dict()
    assert set(own) == set(sd)
    for k in sd:
        assert torch.equal(own[k], torch.from_numpy(sd[k])), k
