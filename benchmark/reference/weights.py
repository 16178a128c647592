"""Weights made from the seed, on the device, in a few large calls.

Every conv and linear weight and bias is drawn as PyTorch initialises a
fresh layer (uniform in +-1/sqrt(fan_in)), but cut from one flat uniform
draw of a ``torch.Generator`` seeded with the seed, in the order of the
reference's state dict.  BatchNorm takes weight 1, bias 0 and fresh
statistics (``fresh``: the network a training run starts from), or, for a
network that stands in for trained weights (``bn_calibrated``), the running
statistics that the reference measures in training mode on a few of the
cell's own seeded requests (``calibrate_batchnorm``): then every normalised
layer sees its inputs at unit scale, as in a trained network.  (With fresh
statistics the activations shrink through the 3D U-Nets, the depth softmax
is all but flat and the depth maps hardly vary, so no comparison of depths
could tell bfloat16 from fp8; with larger weights instead, some seeds drive
the decoder's output to hundreds.)
The VGG16 weights of the perceptual loss (ten 3x3 convs) are drawn the
same way, He-uniform with biases in +-0.05, so none is zero.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

_WEIGHTED = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)
# (c_in, c_out) of VGG16's first ten convs, the four blocks the loss taps.
VGG_CONVS = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
             (256, 512), (512, 512), (512, 512)]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    return g


def network_state(network: nn.Module, seed: int, device) -> dict:
    """{name: tensor on ``device``}: every parameter and buffer of
    ``network`` (the reference's module tree, on any device, ``meta`` too),
    drawn from ``seed``."""
    fans = {}
    for mname, m in network.named_modules():
        if isinstance(m, _WEIGHTED):
            fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
            for pname, _ in m.named_parameters(recurse=False):
                fans[f"{mname}.{pname}"] = fan_in
    sd = network.state_dict()
    total = sum(t.numel() for n, t in sd.items() if n in fans)
    flat = torch.rand(total, generator=generator(seed, device), device=device) * 2 - 1
    state, at = {}, 0
    for name, t in sd.items():
        if name in fans:
            state[name] = (flat[at:at + t.numel()] / math.sqrt(fans[name])).reshape(t.shape)
            at += t.numel()
        else:  # BatchNorm: weight and running_var 1, bias, running_mean and count 0
            one = name.endswith(("weight", "running_var"))
            state[name] = (torch.ones if one else torch.zeros)(t.shape, dtype=t.dtype, device=device)
    return state


@torch.no_grad()
def calibrate_batchnorm(network: nn.Module, requests: list) -> dict:
    """Every BatchNorm's running statistics set to the mean and variance of
    its inputs over ``requests`` (the network in training mode, an eval
    forward each, a cumulative average); returns the state dict."""
    bns = [m for m in network.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    network.train()
    for r in requests:
        network(r)
    for m in bns:
        m.momentum = 0.1
    return {k: v.detach().clone() for k, v in network.state_dict().items()}


def vgg(seed: int, device) -> list:
    """[(weight (O, I, 3, 3), bias (O,))] float32 on ``device``."""
    sizes = [(o * i * 9, o) for i, o in VGG_CONVS]
    total = sum(w + b for w, b in sizes)
    flat = torch.rand(total, generator=generator(seed ^ 0x5EED, device), device=device) * 2 - 1
    out, at = [], 0
    for (c_in, c_out), (nw, nb) in zip(VGG_CONVS, sizes):
        w = flat[at:at + nw].reshape(c_out, c_in, 3, 3) * math.sqrt(6.0 / (c_in * 9))
        b = flat[at + nw:at + nw + nb] * 0.05
        out.append((w, b))
        at += nw + nb
    return out


def vgg_npz(layers: list) -> dict:
    """The weights as the measured program's workspace file holds them:
    ``conv{i}_w`` HWIO and ``conv{i}_b``, numpy float32."""
    out = {}
    for i, (w, b) in enumerate(layers):
        out[f"conv{i}_w"] = w.permute(2, 3, 1, 0).contiguous().cpu().numpy()
        out[f"conv{i}_b"] = b.cpu().numpy()
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}
