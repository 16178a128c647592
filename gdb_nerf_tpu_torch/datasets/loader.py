"""Data loader factory: dataset registry, samplers, threaded prefetch.

Replaces the reference's torch DataLoader stack
(its datasets/make_dataset.py) with a dependency-free loader:
a registry maps the YAML ``*_dataset_module`` strings to reader classes, a
batch sampler yields (idx, views, scale) tuples, worker threads decode
images, and batches are collated into stacked numpy arrays (channels-last)
ready for device transfer.  Threads (not processes) are the right tool
here: cv2.imread and np ops release the GIL, and the arrays go straight to
the device without pickling.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

import numpy as np

from gdb_nerf_tpu_torch.datasets import samplers as S

_DATASETS: dict[str, str] = {
    "datasets.dataloader.dtu": "gdb_nerf_tpu_torch.datasets.dtu",
    "datasets.dataloader.llff": "gdb_nerf_tpu_torch.datasets.llff",
    "datasets.dataloader.nerf": "gdb_nerf_tpu_torch.datasets.nerf",
    "datasets.synthetic": "gdb_nerf_tpu_torch.datasets.synthetic",
}


def resolve_dataset(module_name: str):
    """Map a reference-style dataset module string to our Dataset class."""
    import importlib

    target = _DATASETS.get(module_name, module_name)
    return importlib.import_module(target).Dataset


def collate(items: list[dict]) -> dict:
    """Stack a list of sample dicts into a batch dict of arrays."""

    def rec(vals):
        first = vals[0]
        if isinstance(first, dict):
            return {k: rec([v[k] for v in vals]) for k in first}
        if isinstance(first, (list, tuple)):
            return [rec([v[i] for v in vals]) for i in range(len(first))]
        if isinstance(first, np.ndarray):
            return np.stack(vals)
        if isinstance(first, (int, float, np.integer, np.floating)):
            return np.asarray(vals)
        return list(vals)  # strings and misc stay as lists

    batch = {}
    first = items[0]
    for k in first:
        if k == "meta":
            batch[k] = {
                mk: [it["meta"][mk] for it in items] for mk in first["meta"]
            }
        else:
            batch[k] = rec([it[k] for it in items])
    return batch


class DataLoader:
    """Iterates a batch sampler, loading items with a small thread pool."""

    def __init__(self, dataset, batch_sampler, num_workers: int = 4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(0, num_workers)

    def __len__(self):
        return len(self.batch_sampler)

    def _load(self, spec):
        return self.dataset[spec]

    def __iter__(self):
        if self.num_workers == 0:
            for batch_spec in self.batch_sampler:
                yield collate([self._load(s) for s in batch_spec])
            return

        # Pipelined: a producer thread walks the sampler and fans item loads
        # out to a pool, keeping a bounded queue of ready batches.
        from concurrent.futures import ThreadPoolExecutor

        done = object()
        q: queue.Queue = queue.Queue(maxsize=2)

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch_spec in self.batch_sampler:
                    items = list(pool.map(self._load, batch_spec))
                    q.put(collate(items))
            q.put(done)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        t.join()


def make_data_loader(
    cfg: Any,
    is_train: bool,
    max_iter: int = -1,
    num_shards: int = 1,
    shard_id: int = 0,
):
    """Build the loader for the train or test split.

    Mirrors make_data_loader (make_dataset.py:65-88): dataset from the
    configured module string, random/sequential (or sharded) sampler, the
    'enerf' or default batch sampler, and an iteration-based wrapper when
    ``max_iter != -1``.
    """
    section = cfg.train if is_train else cfg.test
    ds_cfg = cfg.train_dataset if is_train else cfg.test_dataset
    ds_kwargs = {k: v for k, v in vars(ds_cfg).items()}

    if getattr(cfg, "synthetic", False):
        module = "datasets.synthetic"
        ds_kwargs = {"split": ds_kwargs.get("split", "test")}
    else:
        module = cfg.train_dataset_module if is_train else cfg.test_dataset_module
    dataset = resolve_dataset(module)(cfg, **ds_kwargs)

    shuffle = is_train and getattr(cfg.train, "shuffle", True)
    if num_shards > 1:
        sampler = S.ShardedSampler(len(dataset), num_shards, shard_id, shuffle)
    elif shuffle:
        sampler = S.RandomSampler(len(dataset))
    else:
        sampler = S.SequentialSampler(len(dataset))

    name = getattr(section, "batch_sampler", "default")
    if name == "enerf":
        batch_sampler = S.EnerfBatchSampler(
            sampler, section.batch_size, drop_last=False,
            sampler_meta=section.sampler_meta,
        )
    elif name == "image_size":
        # ImageSizeBatchSampler yields (idx, h, w) crop tuples, but every
        # shipped dataset __getitem__ unpacks (idx, views, scale)
        # EnerfBatchSampler tuples — h would be silently consumed as a view
        # count.  No shipped config selects this sampler (latent in the
        # reference too); warn loudly until a crop-aware dataset exists.
        import warnings

        warnings.warn(
            "batch_sampler 'image_size' emits (idx, h, w) tuples, which the "
            "shipped datasets would misread as (idx, views, scale); use it "
            "only with a dataset that accepts crop tuples",
            stacklevel=2,
        )
        meta = section.sampler_meta
        batch_sampler = S.ImageSizeBatchSampler(
            sampler, section.batch_size, drop_last=False,
            min_hw=tuple(getattr(meta, "min_hw", (256, 256))),
            max_hw=tuple(getattr(meta, "max_hw", (480, 640))),
            strategy=getattr(meta, "strategy", "random"),
        )
    else:
        batch_sampler = S.DefaultBatchSampler(
            sampler, section.batch_size, drop_last=False,
            sampler_meta=section.sampler_meta,
        )
    if max_iter != -1:
        batch_sampler = S.IterationBasedBatchSampler(batch_sampler, max_iter)

    num_workers = getattr(cfg.train, "num_workers", 4)
    return DataLoader(dataset, batch_sampler, num_workers)
