"""GDB-NeRF in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A second implementation of the eval forward of ``gdb_nerf_tpu`` (the JAX
package, which stays the reference): FPN -> two-stage MVS cascade -> bundle
sampling and encoding -> BundleNeRF head -> compositing -> RDN decoder.

Layout mirrors ``gdb_nerf_tpu``: ``ops/`` (geometry, sampling, compositing),
``models/`` (nn.Modules with the reference's torch parameter names),
``kernels/`` (Python wrappers of the CUDA kernels in ``csrc/``),
``runtime/`` (renderer, network factory), ``utils/`` (weight conversion,
file readers), ``config/`` and ``datasets/`` (the host layer: YAML config,
dataset readers, samplers, loader), ``tools/`` (microbenchmarks).

This package imports torch and never jax, and nothing of ``gdb_nerf_tpu``:
its host layer is its own copy, under the same file names.
"""
