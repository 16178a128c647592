"""Multi-process execution: data-parallel start-up, collectives and
row-sharded inference (the port of ``gdb_nerf_tpu/parallel``)."""

from gdb_nerf_tpu_torch.parallel.hosts import default_group, maybe_initialize_distributed
from gdb_nerf_tpu_torch.parallel.infer import ShardedRenderer

# default_group stands where the JAX package exports make_infer_mesh.
__all__ = ["ShardedRenderer", "default_group", "maybe_initialize_distributed"]
