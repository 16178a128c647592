"""bf16 training on float32 master weights.

The JAX Network trains with ``compute_dtype "bfloat16"`` on float32
parameters: flax casts each layer's float32 kernel to bf16 where the layer
computes (round to nearest even), and the cast's VJP hands the float32
parameter the float32 value of its bf16 gradient.  ``MixedPrecision`` is
that semantic for the port:

* ``master`` is a float32 ``Network``.  The optimizer updates its
  parameters, and its state dict is what a checkpoint holds.
* ``compute`` is a copy of it in which ``Network.set_compute_dtype`` cast
  every conv and linear weight outside ``Network.float32_layers`` to bf16.
  Every parameter and buffer it did not cast (the kept float32 layers,
  BatchNorm's weights and running statistics) is the master's own tensor,
  so their gradients and updates land on the master directly.
* ``refresh`` rounds the master's cast weights into the copy before each
  forward; ``gather_grads`` writes each cast weight's bf16 gradient into
  its master's float32 ``.grad`` after the backward.

``models/`` and the eval path are untouched: state-dict keys stay the
reference's, and no autocast reaches the geometry.
"""

from __future__ import annotations

import copy

import torch


class MixedPrecision:
    def __init__(self, master: torch.nn.Module, dtype: torch.dtype):
        self.master = master
        self.compute = copy.deepcopy(master).set_compute_dtype(dtype)
        self.pairs: list[tuple[torch.nn.Parameter, torch.nn.Parameter]] = []
        for m, c in zip(master.modules(), self.compute.modules()):
            for name, p in m._parameters.items():
                if p is None:
                    continue
                if c._parameters[name].dtype == p.dtype:
                    c._parameters[name] = p
                else:
                    self.pairs.append((p, c._parameters[name]))
            for name, b in m._buffers.items():
                c._buffers[name] = b

    @torch.no_grad()
    def refresh(self) -> None:
        """The compute copy's cast weights set to the master's, rounded."""
        for p, c in self.pairs:
            c.copy_(p)
            c.grad = None

    @torch.no_grad()
    def gather_grads(self) -> None:
        """Each cast weight's gradient added into its master's ``.grad``, in
        float32 (a weight the loss did not reach adds nothing)."""
        for p, c in self.pairs:
            if c.grad is not None:
                p.grad.add_(c.grad)
