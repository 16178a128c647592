"""Python wrappers of the hand-written CUDA kernels in ``csrc/``."""
