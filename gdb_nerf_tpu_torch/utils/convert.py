"""Carry JAX weights into the port: the inverse of tools/convert_checkpoint.py.

``state_dict_from_jax`` takes the JAX Network's ``{"params",
"batch_stats"}`` tree (nested dicts of numpy arrays) and returns the torch
state dict under the reference's names, undoing every layout change of
``convert_checkpoint.convert``:

  * conv kernels HWIO -> OIHW and DHWIO -> OIDHW;
  * transposed-conv kernels: the spatial flip undone, DHWIO -> (I, O, D, H, W);
  * dense kernels (I, O) -> Linear weights (O, I);
  * split denses re-concatenated along the input axis, the bias taken from
    the split that carries it;
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
    with ``num_batches_tracked`` = 0 (JAX keeps no counter).

Imports no jax: the tree is plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv(w: np.ndarray) -> np.ndarray:
    """(k..., I, O) -> (O, I, k...)."""
    nd = w.ndim - 2
    return w.transpose(nd + 1, nd, *range(nd))


def _deconv(w: np.ndarray) -> np.ndarray:
    """DHWIO gather-orientation kernel -> torch ConvTranspose3d (I, O, k, k, k)."""
    return w.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1]


class _Inverter:
    def __init__(self, variables: dict):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree: dict, path: str) -> np.ndarray:
        node = tree
        for k in path.split("/"):
            node = node[k]
        return np.asarray(node)

    def p(self, path: str) -> np.ndarray:
        return self._get(self.params, path)

    def bn(self, jname: str, tname: str) -> None:
        self.sd[f"{tname}.weight"] = self.p(f"{jname}/scale")
        self.sd[f"{tname}.bias"] = self.p(f"{jname}/bias")
        self.sd[f"{tname}.running_mean"] = self._get(self.stats, f"{jname}/mean")
        self.sd[f"{tname}.running_var"] = self._get(self.stats, f"{jname}/var")
        self.sd[f"{tname}.num_batches_tracked"] = np.array(0, np.int64)

    def conv_block(self, jname: str, tname: str) -> None:
        self.sd[f"{tname}.0.weight"] = _conv(self.p(f"{jname}/Conv_0/kernel"))
        self.bn(f"{jname}/BatchNorm_0", f"{tname}.1")

    def deconv_block(self, jname: str, tname: str) -> None:
        self.sd[f"{tname}.0.weight"] = _deconv(self.p(f"{jname}/kernel"))
        self.bn(f"{jname}/BatchNorm_0", f"{tname}.1")

    def conv(self, jname: str, tname: str, bias: bool = True) -> None:
        self.sd[f"{tname}.weight"] = _conv(self.p(f"{jname}/kernel"))
        if bias:
            self.sd[f"{tname}.bias"] = self.p(f"{jname}/bias")

    def dense(self, jname: str, tname: str, bias: bool = True) -> None:
        self.sd[f"{tname}.weight"] = self.p(f"{jname}/kernel").T
        if bias:
            self.sd[f"{tname}.bias"] = self.p(f"{jname}/bias")

    def dense_join(self, tname: str, splits: list[tuple[str, bool]]) -> None:
        """Re-concatenate split denses [(jname, has_bias)] into one Linear."""
        self.sd[f"{tname}.weight"] = np.concatenate(
            [self.p(f"{j}/kernel").T for j, _ in splits], axis=1
        )
        (bias_from,) = [j for j, has_bias in splits if has_bias]
        self.sd[f"{tname}.bias"] = self.p(f"{bias_from}/bias")


def _head(c: _Inverter, j: str, t: str, weight_name: str, j0_shared: str, j0_view: str) -> None:
    """The aggregation trunk, lr0, sigma and the first layer of the view
    weights of the JAX head ``j`` into the port's head ``t``."""
    agg = c.params
    for k in f"{j}/agg".split("/"):
        agg = agg[k]
    if "view_fc" in agg:
        c.dense(f"{j}/agg/view_fc", f"{t}.view_fc.0")
    c.dense_join(f"{t}.global_fc.0", [
        (f"{j}/agg/global_fc_pv", False),
        (f"{j}/agg/global_fc_var", False),
        (f"{j}/agg/global_fc_mean", True),
    ])
    c.dense(f"{j}/agg/agg_w_fc", f"{t}.agg_w_fc.0")
    c.dense(f"{j}/agg/fc", f"{t}.fc.0")
    c.dense(f"{j}/lr0", f"{t}.lr0.0")
    c.dense(f"{j}/sigma", f"{t}.sigma.0")
    c.dense_join(f"{t}.{weight_name}.0", [(f"{j}/{j0_shared}", True), (f"{j}/{j0_view}", False)])


def _stage_nerf(c: _Inverter, j: str, t: str) -> None:
    """The JAX ``StageNeRF`` at ``j`` into the port's ``StageNeRF`` at ``t``."""
    _head(c, j, t, "color", "color0_shared", "color0_view")
    c.dense(f"{j}/color1", f"{t}.color.2")


def stage_nerf_from_jax(params: dict) -> dict:
    """The port's ``StageNeRF`` state dict from a JAX ``StageNeRF``'s params."""
    c = _Inverter({"params": {"stage": params}})
    _stage_nerf(c, "stage", "stage")
    return {k.removeprefix("stage."): torch.from_numpy(np.array(v, order="C"))
            for k, v in c.sd.items()}


def state_dict_from_jax(variables: dict, num_stages: int = 2, dec_layers: int = 3) -> dict:
    """The port's state dict (torch tensors) from a JAX Network's variables."""
    c = _Inverter(variables)

    fn = "feature_net"
    for i, blk in enumerate(("conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv2.0", "conv2.1")):
        c.conv_block(f"{fn}/ConvBlock_{i}", f"{fn}.{blk}")
    c.conv(f"{fn}/Conv_0", f"{fn}.out0")
    c.conv(f"{fn}/Conv_1", f"{fn}.inner1")
    c.conv(f"{fn}/Conv_2", f"{fn}.out1", bias=False)
    c.conv(f"{fn}/Conv_3", f"{fn}.inner2")
    c.conv(f"{fn}/Conv_4", f"{fn}.out2", bias=False)

    for s in range(num_stages):
        t = f"depth_net.cost_regs.{s}"
        j = f"depth_net/{'CostRegNetSmall_0' if s == 0 else 'CostRegNet_0'}"
        n_convs, deconvs = (5, ["conv5", "conv6"]) if s == 0 else (7, ["conv7", "conv8", "conv9"])
        for i in range(n_convs):
            c.conv_block(f"{j}/ConvBlock_{i}", f"{t}.conv{i}")
        for i, name in enumerate(deconvs):
            c.deconv_block(f"{j}/DeconvBlock_{i}", f"{t}.{name}")
        c.conv(f"{j}/Conv_0", f"{t}.feat_head", bias=False)
        c.conv(f"{j}/Conv_1", f"{t}.prob_head", bias=False)

    for s in range(num_stages - 1):
        j, t = f"depth_net/stage_nerf_{s}", f"depth_net.nerfs.{s}"
        _stage_nerf(c, j, t)

    _head(c, "nerf", "nerf", "weight", "weight0_shared", "weight0_view")
    c.dense("nerf/weight1", "nerf.weight.2")
    c.dense("nerf/feat_head", "nerf.feat_head.0")

    j = t = "upsampler"
    c.conv(f"{j}/Conv_0", f"{t}.in_conv")
    for b in range(dec_layers):
        rb = f"{j}/ResidualDenseBlock_{b}"
        c.conv(f"{rb}/Conv_0", f"{t}.blocks.{b}.conv1", bias=False)
        c.conv(f"{rb}/Conv_1", f"{t}.blocks.{b}.conv2", bias=False)
        c.conv(f"{rb}/Conv_2", f"{t}.blocks.{b}.conv3", bias=False)
        c.dense(f"{rb}/SEBlock_0/Dense_0", f"{t}.blocks.{b}.se.fc.0", bias=False)
        c.dense(f"{rb}/SEBlock_0/Dense_1", f"{t}.blocks.{b}.se.fc.2", bias=False)
    convs = sorted(int(k.split("_")[1]) for k in c.params[j] if k.startswith("Conv_"))
    for u, ci in enumerate(convs[1:-1]):
        c.conv(f"{j}/Conv_{ci}", f"{t}.up.{2 * u}")
    c.conv(f"{j}/Conv_{convs[-1]}", f"{t}.out_conv")

    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in c.sd.items()}
