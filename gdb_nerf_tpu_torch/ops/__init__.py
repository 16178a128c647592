"""Geometry, sampling, compositing: plain functions on tensors."""
