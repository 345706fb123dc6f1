"""Host-side batch loader with background prefetch.

The port's counterpart of rave_tpu/data/loader.py::Loader: a thread pool
makes each batch from the dataset's numpy transforms, every sample drawn
from `np.random.default_rng((seed, epoch, index))`, so the port and the JAX
package make the same batches from the same seed and epoch. The one
difference is the layout: batches come out as [B, C, T] float32 (the JAX
loader's [B, T, C], transposed once here). The loop moves them to the card
from pinned memory (train/loop.py). The C++ sampler (`NativeLoader`) is not
ported (ROADMAP A17).
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
    ):
        self.dataset = dataset
        self.indices = np.asarray(indices)
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
        rng = np.random.default_rng((self.seed, epoch))
        n = len(self.indices)
        idx = self.indices[rng.permutation(n) if self.shuffle else np.arange(n)]
        pending: collections.deque = collections.deque()
        pool = ThreadPoolExecutor(max_workers=self.workers)
        try:
            for b in range(len(self)):
                pending.append(pool.submit(self._make_batch, idx, b, epoch))
                if len(pending) > PREFETCH:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def forever(self) -> Iterator[np.ndarray]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
