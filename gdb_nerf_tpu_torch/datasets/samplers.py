"""Batch samplers for the data pipeline.

Reproduces the reference's sampler semantics
(its datasets/samplers.py):

  * ``EnerfBatchSampler`` smuggles a per-batch random source-view count and
    render scale into the dataset index as ``(idx, views, scale)`` tuples.
  * ``IterationBasedBatchSampler`` re-iterates an inner sampler until a
    fixed number of iterations is produced (fixed ep_iter epochs).
  * ``ShardedSampler`` replaces the NCCL-era DistributedSampler: it pads the
    index list to a multiple of (num_shards * batch) and slices a
    contiguous per-host shard, epoch-seeded — used for multi-host input
    pipelines where each host feeds its own devices.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler:
    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter(rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class ShardedSampler:
    """Contiguous per-shard slice of an epoch-seeded permutation (padded)."""

    def __init__(self, n: int, num_shards: int, shard_id: int, shuffle: bool = True,
                 seed: int = 0):
        self.n = n
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-n // num_shards)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.n).tolist()
        else:
            indices = list(range(self.n))
        total = self.num_samples * self.num_shards
        indices += indices[: total - len(indices)]
        offset = self.num_samples * self.shard_id
        return iter(indices[offset : offset + self.num_samples])

    def __len__(self):
        return self.num_samples


class EnerfBatchSampler:
    """Yields batches of (idx, input_views_num, render_scale) tuples.

    The view count and scale are drawn once per batch from the config's
    sampler_meta distributions, so every element of a batch shares its
    shape — a requirement for stacking (and for jit shape reuse).
    """

    def __init__(self, sampler, batch_size: int, drop_last: bool, sampler_meta,
                 seed: int = 0):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.views = list(sampler_meta.input_views_num)
        self.views_prob = list(sampler_meta.input_views_prob)
        self.scales = list(getattr(sampler_meta, "render_scale", [1.0]))
        self.scales_prob = list(getattr(sampler_meta, "scale_prob", [1.0]))
        self.rng = np.random.default_rng(seed)

    def _draw(self):
        views = int(self.rng.choice(self.views, p=self.views_prob))
        scale = float(self.rng.choice(self.scales, p=self.scales_prob))
        return views, scale

    def __iter__(self) -> Iterator[list[tuple]]:
        batch = []
        views, scale = self._draw()
        for idx in self.sampler:
            batch.append((idx, views, scale))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
                views, scale = self._draw()
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


class DefaultBatchSampler:
    """Plain batching with a fixed view count (the first configured)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool, sampler_meta,
                 seed: int = 0):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        views = list(sampler_meta.input_views_num) or [3]
        self.views = views[0]

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append((idx, self.views, 1.0))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


class IterationBasedBatchSampler:
    """Loop an inner batch sampler until num_iterations batches were yielded."""

    def __init__(self, batch_sampler, num_iterations: int, start_iter: int = 0):
        self.batch_sampler = batch_sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler.sampler, "set_epoch"):
            self.batch_sampler.sampler.set_epoch(epoch)

    def __iter__(self):
        iteration = self.start_iter
        while iteration < self.num_iterations:
            for batch in self.batch_sampler:
                iteration += 1
                if iteration > self.num_iterations:
                    break
                yield batch

    def __len__(self):
        return self.num_iterations


class ImageSizeBatchSampler:
    """Batches carrying a per-batch random crop size: yields (idx, h, w).

    Format-faithful to the reference sampler
    (the reference's datasets/samplers.py:44-81): every batch draws one
    (h, w) in [min_hw, max_hw] rounded UP to the next multiple of 32 (the
    reference's ``(v | 31) + 1``), or (-1, -1) under the 'origin' strategy.
    Like the reference, it pairs with datasets whose ``__getitem__`` accepts
    (idx, h, w) crop tuples — the gdb_nerf datasets take
    (idx, views, scale) tuples from EnerfBatchSampler instead, in both
    codebases.
    """

    def __init__(self, sampler, batch_size: int, drop_last: bool,
                 min_hw=(256, 256), max_hw=(480, 640), strategy: str = "random",
                 seed: Optional[int] = 0):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.min_hw = min_hw
        self.max_hw = max_hw
        self.strategy = strategy
        self.divisor = 32
        self.rng = np.random.default_rng(seed)

    def _draw_hw(self):
        if self.strategy == "origin":
            return -1, -1
        h = int(self.rng.integers(self.min_hw[0], self.max_hw[0] + 1))
        w = int(self.rng.integers(self.min_hw[1], self.max_hw[1] + 1))
        return (h | (self.divisor - 1)) + 1, (w | (self.divisor - 1)) + 1

    def __iter__(self):
        batch = []
        h, w = self._draw_hw()
        for idx in self.sampler:
            batch.append((idx, h, w))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
                h, w = self._draw_hw()
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)
