"""The training cell's data set, read by the measured program's own loader.

The configuration names this module as its ``train_dataset_module``; the
program's loader factory imports it and builds ``Dataset(cfg, **train_dataset)``,
where the runner has put the seed, the scene count, the frame size and the
device into ``train_dataset``.  The scenes are the frozen synthetic scenes
(``reference/scenes.py``), rendered on the device in one go at set-up and
held in host memory, so an item costs what a decoded image costs: a slice.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import scenes


class Dataset:
    def __init__(self, cfg, split: str = "train", seed: int = 0, scenes_n: int = 16,
                 hw=(512, 640), device="cpu", **_):
        self.vol_scales = list(cfg.mvs.vol_scales)
        self.K = scenes.intrinsics(hw)
        self.exts = scenes.extrinsics(seed, scenes_n)
        self.images = scenes.render(self.exts, self.K, hw, device).cpu().numpy()

    def __len__(self):
        return len(self.exts)

    def item(self, index: int, views: int) -> dict:
        return scenes.train_item(self.images[index], self.exts[index], self.K, views,
                                 self.vol_scales)

    def __getitem__(self, index_meta):
        index, views, render_scale = index_meta
        out = self.item(index, views)
        out["render_scale"] = render_scale
        out["meta"] = {"scene": index, "views": views}
        return out


def collate(items: list) -> dict:
    """The reference's own stacking of items into a batch."""

    def rec(vals):
        if isinstance(vals[0], dict):
            return {k: rec([v[k] for v in vals]) for k in vals[0]}
        if isinstance(vals[0], list):
            return [rec([v[i] for v in vals]) for i in range(len(vals[0]))]
        return np.stack(vals)

    return rec(items)


def same_arrays(a, b) -> bool:
    """Whether two batches hold the same arrays, element for element, in
    every field the loss reads."""
    if isinstance(b, dict):
        return all(same_arrays(a[k], b[k]) for k in b)
    if isinstance(b, list):
        return len(a) == len(b) and all(same_arrays(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))
