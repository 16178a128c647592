"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense, no sparsity): device memory bytes/s and FLOP/s by the type the
products run in."""

BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}


def bound_s(n_bytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the operations over its peak for ``dtype``."""
    return max(n_bytes / BYTES_PER_S, flops / FLOPS[dtype])
