"""The epoch-seeded sharded sampler of ``spsnet_tpu/data/loader.py:22-49``
(parity: ``torch.utils.data.DistributedSampler``): each rank takes every
``num_shards``-th index of one shuffled order of the dataset, the order
drawn from ``seed + epoch``. The rest of that module (the prefetching
loader) waits for ROADMAP item G1."""
from __future__ import annotations

import numpy as np


class ShardedSampler:
    """Epoch-seeded shuffled index sharding (parity: DistributedSampler).
    ``drop_last`` drops the tail that the shards do not divide; otherwise
    the order wraps around to pad it."""

    def __init__(self, dataset_len, num_shards=1, shard_id=0, shuffle=True,
                 drop_last=True, seed=0):
        self.dataset_len = dataset_len
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def indices(self):
        idx = np.arange(self.dataset_len)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.drop_last:
            per = self.dataset_len // self.num_shards
            idx = idx[:per * self.num_shards]
        else:
            pad = (-len(idx)) % self.num_shards
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.shard_id::self.num_shards]
