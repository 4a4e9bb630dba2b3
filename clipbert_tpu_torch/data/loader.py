# Copied from clipbert_tpu/data/loader.py (ShardedBatchSampler, DataLoader, InfiniteIterator; PrefetchLoader on torch streams): numpy only, kept importable without jax.
"""Batch loaders: sharded sampling, threaded prefetch, the device prefetch
and the infinite epoch iterator.

Reference equivalents: torch DataLoader + DistributedSampler per rank
(`src/tasks/run_video_retrieval.py:109-121`) and the side-stream
PrefetchLoader (`src/dataloaders/dataloader.py:86-162`). Each process takes
its ``(process_index, process_count)`` slice of the epoch order; worker
threads build the next batches while the device runs the current one (PIL,
numpy and the native decoder release the GIL for the heavy parts). The
multi-task ``MetaLoader`` waits for the pretraining slice of the port.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


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



class PrefetchLoader:
    """Wraps a loader: moves each batch to ``device`` one step ahead, so the
    host-to-device copy overlaps the step that runs meanwhile (the
    reference's side-stream prefetch, dataloader.py:86-152). Yields dicts
    whose numeric arrays are device tensors (other values pass through).

    On CUDA the copies come from pinned memory on a side stream, and
    ``preprocess_fn`` (the device resize / pad / normalize) runs there too,
    one batch ahead of the consuming step; the consuming stream waits on an
    event recorded after them, and every tensor handed over is recorded on
    it (``record_stream``), so the allocator keeps its memory until the
    step is done with it."""

    def __init__(self, loader, device: torch.device | str = "cpu",
                 preprocess_fn: Optional[Callable[[Dict], Dict]] = None):
        self.loader = loader
        self.device = torch.device(device)
        self.preprocess_fn = preprocess_fn
        self._stream = None

    @property
    def sampler(self):
        return getattr(self.loader, "sampler", None)

    def _put(self, batch: Dict):
        on_cuda = self.device.type == "cuda"
        if on_cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream) if on_cuda else \
                contextlib.nullcontext():
            out = {}
            for k, v in batch.items():
                if isinstance(v, np.ndarray) and v.dtype != object:
                    t = torch.from_numpy(np.ascontiguousarray(v))
                    if on_cuda:
                        t = t.pin_memory().to(self.device, non_blocking=True)
                    else:
                        t = t.to(self.device)
                    out[k] = t
                else:
                    out[k] = v
            if self.preprocess_fn is not None:
                out = self.preprocess_fn(out)
            ready = None
            if on_cuda:
                ready = torch.cuda.Event()
                ready.record(self._stream)
        return out, ready

    def _hand_over(self, pending) -> Dict:
        out, ready = pending
        if ready is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(ready)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(main)
        return out

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        try:
            pending = self._put(next(it))
        except StopIteration:
            return
        for batch in it:
            nxt = self._put(batch)   # enqueue the next transfer
            yield self._hand_over(pending)
            pending = nxt
        yield self._hand_over(pending)


class InfiniteIterator:
    """Restart the underlying loader each epoch (dataloader.py:155-162),
    advancing the sampler epoch for fresh shuffles."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        epoch = 0
        while True:
            sampler = getattr(self.loader, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            yielded = False
            for batch in self.loader:
                yielded = True
                yield batch
            if not yielded:
                raise RuntimeError("empty loader in InfiniteIterator")
            epoch += 1
