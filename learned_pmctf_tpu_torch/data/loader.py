"""Multi-threaded prefetching data loader of numpy batches.

A copy of learned_pmctf_tpu/data/loader.py: a thread pool and a bounded
prefetch queue (decoding releases the interpreter lock), batches
collated with numpy; the trainer moves each batch to its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __iter__(self) -> Iterator:
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        batch_iter = self._batches()
        lock = threading.Lock()
        n_batches = len(self)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                with lock:
                    batch_idx = next(batch_iter, None)
                if batch_idx is None:
                    out_q.put(None)
                    return
                samples = [self.dataset[int(i)] for i in batch_idx]
                out_q.put(_collate(samples))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        finished_workers = 0
        yielded = 0
        try:
            while yielded < n_batches:
                item = out_q.get()
                if item is None:
                    finished_workers += 1
                    if finished_workers == self.num_workers:
                        break
                    continue
                yielded += 1
                yield item
        finally:
            stop.set()
            # drain so workers blocked on put() can exit
            while not out_q.empty():
                out_q.get_nowait()


def _collate(samples):
    first = samples[0]
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, (tuple, list)):
        return type(first)(_collate([s[i] for s in samples])
                           for i in range(len(first)))
    raise TypeError(type(first))
