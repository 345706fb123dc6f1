"""Host-side batch loaders with background prefetch.

The port's counterparts of rave_tpu/data/loader.py:

  * `Loader`: a thread pool makes each batch from the dataset's numpy
    transforms, every sample drawn from
    `np.random.default_rng((seed, epoch, index))`;
  * `NativeLoader`: the C++ sampler (data/native.py) makes each batch of
    the standard pipeline (crop, phase mangle, dither) from the store,
    with `epoch_tag = epoch + 1`.

Both permute their indices per epoch with `default_rng((seed, epoch))`, so
the port and the JAX package make the same batches from the same seed and
epoch, and both take `host_id` / `host_count`: a process of a
data-parallel run samples only its shard `indices[host_id::host_count]`.
The one difference is the layout: batches come out as [B, C, T] float32
(the JAX loaders' [B, T, C], transposed once here). The loop moves them to
the card from pinned memory (train/loop.py).
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

# batches the pool makes ahead of the one being consumed
PREFETCH = 4


class Loader:
    def __init__(
        self,
        dataset,
        indices: Sequence[int],
        batch: int,
        seed: int = 0,
        shuffle: bool = True,
        workers: int = 8,
        drop_last: bool = True,
        host_id: int = 0,
        host_count: int = 1,
    ):
        self.dataset = dataset
        self.indices = np.asarray(indices)[host_id::host_count]  # this process's shard
        self.batch = batch
        self.seed = seed
        self.shuffle = shuffle
        self.workers = workers
        self.drop_last = drop_last

    def __len__(self):
        if self.drop_last:
            return len(self.indices) // self.batch
        return -(-len(self.indices) // self.batch)

    def _make_batch(self, idx: np.ndarray, b: int, epoch: int) -> np.ndarray:
        rows = idx[b * self.batch : (b + 1) * self.batch]
        xs = [self.dataset.get(int(i), np.random.default_rng((self.seed, epoch, int(i))))
              for i in rows]
        return np.ascontiguousarray(np.stack(xs).astype(np.float32).transpose(0, 2, 1))

    def epoch(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """Yield [B, C, T] float32 batches for one epoch, up to PREFETCH
        batches made ahead by the pool."""
        return _prefetched(self._make_batch, epoch_order(self, epoch), len(self), epoch,
                           self.workers)

    def forever(self) -> Iterator[np.ndarray]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1


def epoch_order(loader, epoch: int) -> np.ndarray:
    """The loader's indices in the order of `epoch` (shuffled by (seed, epoch))."""
    n = len(loader.indices)
    rng = np.random.default_rng((loader.seed, epoch))
    return loader.indices[rng.permutation(n) if loader.shuffle else np.arange(n)]


def _prefetched(make_batch, idx: np.ndarray, n_batches: int, epoch: int,
                workers: int) -> Iterator[np.ndarray]:
    """make_batch(idx, b, epoch) for b < n_batches, in order, up to PREFETCH
    made ahead by a pool of `workers` threads."""
    pending: collections.deque = collections.deque()
    pool = ThreadPoolExecutor(max_workers=workers)
    try:
        for b in range(n_batches):
            pending.append(pool.submit(make_batch, idx, b, epoch))
            if len(pending) > PREFETCH:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


class NativeLoader:
    """The loader over the C++ sampler for the standard pipeline of a
    non-lazy local store (rave_tpu/data/loader.py:94-161): one thread
    drives the sampler, whose own threads assemble each batch's rows."""

    def __init__(
        self,
        db_path: str,
        indices: Sequence[int],
        batch: int,
        crop: int,
        sr: int,
        seed: int = 0,
        shuffle: bool = True,
        host_id: int = 0,
        host_count: int = 1,
        drop_last: bool = True,
    ):
        from rave_tpu_torch.data.native import NativeSampler
        from rave_tpu_torch.data.store import read_metadata

        meta = read_metadata(db_path)
        if meta.get("lazy", False):
            raise ValueError("the native loader needs a non-lazy ARS store")
        self.sampler = NativeSampler(db_path, meta["num_signal"], meta["channels"], crop, sr,
                                     seed=seed)
        self.indices = np.asarray(indices)[host_id::host_count]
        self.batch = batch
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last

    def __len__(self):
        if self.drop_last:
            return len(self.indices) // self.batch
        return -(-len(self.indices) // self.batch)

    def _make_batch(self, idx: np.ndarray, b: int, epoch: int) -> np.ndarray:
        rows = idx[b * self.batch : (b + 1) * self.batch]
        x = self.sampler.sample(rows, epoch_tag=epoch + 1)
        return np.ascontiguousarray(x.transpose(0, 2, 1))

    def epoch(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """Yield [B, C, T] float32 batches for one epoch, up to PREFETCH made ahead."""
        return _prefetched(self._make_batch, epoch_order(self, epoch), len(self), epoch, 1)

    def forever(self) -> Iterator[np.ndarray]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
