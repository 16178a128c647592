"""Row-sharded single-image inference over a process group.

Port of ``gdb_nerf_tpu/parallel/infer.py``.  There the bundle-grid stages
(sampling, encode, the NeRF head, compositing) carry row-tile sharding
constraints and XLA partitions them over the mesh, inserting one
all-gather before the decoder.  Here ``Network.spatial_group`` does the
same by hand: each rank renders its contiguous range of bundle rows (on
the card through the bundle-head kernel) and ``collectives.gather_rows``
brings the feature, depth and opacity maps back to every rank.  The FPN,
the MVS cascade and the decoder read across rows and stay replicated.
"""

from __future__ import annotations

from gdb_nerf_tpu_torch.parallel.hosts import default_group
from gdb_nerf_tpu_torch.runtime.renderer import Renderer


class ShardedRenderer(Renderer):
    """Renders one view with the bundle stages split over the ranks of
    ``group`` (default: the world group), image rows in rank order.

    Sibling of ``runtime.Renderer`` with the same ``render`` and
    ``render_timed``; every rank returns the whole image.  The network's
    ``spatial_group`` is set for the duration of each render only, so a
    network shared with a ``Renderer`` or a trainer stays unsharded there.
    The bundle grid's height (H / bundle_size) must divide by the group's
    size; the forward raises otherwise."""

    def __init__(self, network, device, group=None):
        self.group = group if group is not None else default_group()
        if self.group is None:
            raise ValueError("ShardedRenderer needs a process group of more than one rank")
        super().__init__(network, device)

    def render(self, dev_batch: dict):
        self.network.spatial_group = self.group
        try:
            return super().render(dev_batch)
        finally:
            self.network.spatial_group = None
