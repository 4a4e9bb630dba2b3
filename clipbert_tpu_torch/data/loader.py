# Copied from clipbert_tpu/data/loader.py (ShardedBatchSampler, DataLoader): numpy only, kept importable without jax.
"""Batch loaders, the eval side: sharded sampling and threaded prefetch.

Reference equivalents: torch DataLoader + DistributedSampler per rank
(`src/tasks/run_video_retrieval.py:109-121`). Each process takes its
``(process_index, process_count)`` slice of the epoch order; worker threads
build the next batches while the device runs the current one (PIL, numpy
and the native decoder release the GIL for the heavy parts). The train
side (``PrefetchLoader``, the infinite and multi-task iterators) waits for
the training slice of the port.
"""

from __future__ import annotations

from typing import Callable, Iterator, List

import numpy as np


class ShardedBatchSampler:
    """Shuffled epoch order, sharded across hosts, fixed batch size.

    drop_last=True for training (static shapes); eval tail batches are
    replicated (not sharded) by `tasks.common.device_batch`.
    """

    def __init__(self, dataset_len: int, batch_size: int, shuffle: bool = True,
                 seed: int = 42, process_index: int = 0,
                 process_count: int = 1, drop_last: bool = True):
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(self.dataset_len)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        shard = order[self.process_index::self.process_count]
        n = len(shard)
        if self.drop_last:
            n = (n // self.batch_size) * self.batch_size
        for i in range(0, n, self.batch_size):
            yield shard[i:i + self.batch_size].tolist()

    def __len__(self) -> int:
        per_host = (self.dataset_len + self.process_count - 1
                    ) // self.process_count
        if self.drop_last:
            return per_host // self.batch_size
        return (per_host + self.batch_size - 1) // self.batch_size


class DataLoader:
    """dataset + sampler + collate with threaded prefetch.

    Threads (not processes): the hot work — JPEG/video decode, resize — is
    in C (PIL/torch/native decoder) and releases the GIL.
    """

    def __init__(self, dataset, sampler: ShardedBatchSampler,
                 collate_fn: Callable, num_workers: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return len(self.sampler)

    def _load_batch(self, indices: List[int]):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor
        batches = list(self.sampler)
        if not batches:
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            window = self.num_workers * self.prefetch
            futures = [pool.submit(self._load_batch, b)
                       for b in batches[:window]]
            nxt = window
            for i in range(len(batches)):
                out = futures[i].result()
                if nxt < len(batches):
                    futures.append(pool.submit(self._load_batch, batches[nxt]))
                    nxt += 1
                yield out

