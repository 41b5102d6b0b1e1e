"""Reference-compatible dataset/dataloader factory (port copy of
``copenerf_tpu/data/dataloading.py``).

API mirror of the reference's ``get_dataloader`` / ``OurDataset``
(``dataloading/dataloading.py``): per-view dicts with ``img.*`` keys. The
trainer bypasses this (it keeps the scene resident on the device and indexes
it there), but the iterator remains for tooling, tests, and users migrating
loops from the reference.
"""

from __future__ import annotations

import numpy as np

from .fields import get_data_fields


class OurDataset:
    """Index = view; item = flat dict of ``<field>.<key>`` entries."""

    def __init__(self, fields: dict, n_views: int = 0, mode: str = "train"):
        self.fields = fields
        self.n_views = n_views
        self.mode = mode

    def __len__(self) -> int:
        return self.n_views

    def __getitem__(self, idx: int) -> dict:
        data = {}
        for field_name, field in self.fields.items():
            field_data = field.load(idx)
            for k, v in field_data.items():
                if k is None:
                    data[field_name] = v
                else:
                    data[f"{field_name}.{k}"] = v
        return data


class _Loader:
    """Minimal shuffling iterator (batch size 1, seeded)."""

    def __init__(self, dataset: OurDataset, shuffle: bool, seed=None):
        self.dataset = dataset
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in order:
            yield self.dataset[int(i)]


def get_dataloader(cfg: dict, mode: str = "train", shuffle: bool = True,
                   n_views=None, seed=None):
    """Return (loader, fields) like the reference factory."""
    fields = get_data_fields(cfg, mode)
    if not (n_views is not None and mode == "render"):
        n_views = fields["img"].N_imgs
    dataset = OurDataset(fields, n_views=n_views, mode=mode)
    return _Loader(dataset, shuffle, seed), fields
