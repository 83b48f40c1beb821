"""Threaded prefetching batch loader with per-host sharding — counterpart of
``diffbinaural_tpu/data/loader.py``: worker threads pull samples (numpy and
the native decoder release the GIL), batches are collated on the host and
handed out in order; ``num_shards`` / ``shard_index`` slice the index space
by stride, as ``DistributedSampler`` does.

The batches and their order are the JAX loader's.  Three things differ, none
of them in what a batch holds:

  * the iterator stops its workers when it is closed, exhausted or
    collected: an iterator dropped after ``next(iter(loader))`` leaves no
    thread blocked on a full queue holding a batch;
  * an exception raised while a batch is made is raised to the consumer at
    that batch's turn (the JAX loader's worker dies and the consumer waits
    forever);
  * each worker thread runs torch's CPU ops (the mel frontend) on one
    intra-op thread: the workers are the parallelism.  torch's setting is
    per thread under OpenMP, so the consumer's own setting stays.

Batches are numpy; a loader thread never touches CUDA.  The trainer copies
each batch to the device once.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Callable, Dict, List

import numpy as np
import torch


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) or isinstance(
            vals[0], (int, float, np.number, np.bool_)
        ):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals  # strings etc.
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        collate_fn: Callable = default_collate,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate_fn = collate_fn
        self.seed = seed
        self.epoch = 0
        self.num_shards = num_shards
        self.shard_index = shard_index

    def set_epoch(self, epoch: int):
        """The shuffle of epoch ``epoch`` (``DistributedSampler.set_epoch``)."""
        self.epoch = epoch

    def _indices(self) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        # per-host shard (DistributedSampler semantics: stride slicing)
        idx = idx[self.shard_index :: self.num_shards]
        if self.drop_last:
            idx = idx[: len(idx) - len(idx) % self.batch_size]
        return idx

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> "BatchIterator":
        indices = self._indices()
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        return BatchIterator(self.dataset, self.collate_fn, batches,
                             self.num_workers, self.prefetch)


def _put(out_q: queue.Queue, item, stop: threading.Event) -> bool:
    while not stop.is_set():
        try:
            out_q.put(item, timeout=0.05)
            return True
        except queue.Full:
            pass
    return False


def _work(dataset, collate_fn, job_q, out_q, results, lock, next_emit, stop):
    """One worker: take batch jobs until none is left or ``stop`` is set;
    batches are emitted in their order by whichever worker completes the
    run.  Holds no reference to the iterator, so that an iterator nobody
    holds is collected and stops its workers."""
    torch.set_num_threads(1)
    while not stop.is_set():
        try:
            bi, batch_idx = job_q.get_nowait()
        except queue.Empty:
            return
        try:
            batch = collate_fn([dataset[i] for i in batch_idx])
        except BaseException as exc:  # raised to the consumer in its turn
            batch = exc
        with lock:
            results[bi] = batch
            while next_emit[0] in results:
                if not _put(out_q, results.pop(next_emit[0]), stop):
                    return
                next_emit[0] += 1


class BatchIterator:
    """The batches of one pass, in order, made by ``num_workers`` threads at
    most ``prefetch`` batches ahead of the consumer."""

    def __init__(self, dataset, collate_fn, batches, num_workers: int,
                 prefetch: int):
        self._n = len(batches)
        self._emitted = 0
        self._stop = threading.Event()
        self._out = queue.Queue(maxsize=prefetch)
        job_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            job_q.put((bi, b))
        args = (dataset, collate_fn, job_q, self._out, {}, threading.Lock(),
                [0], self._stop)
        self.threads = [threading.Thread(target=_work, args=args, daemon=True)
                        for _ in range(num_workers if batches else 0)]
        for t in self.threads:
            t.start()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, Any]:
        if self._emitted >= self._n or self._stop.is_set():
            self.close()
            raise StopIteration
        item = self._out.get()
        self._emitted += 1
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def close(self) -> None:
        """Stop the workers: each ends after the sample it is loading; the
        batches made ahead are dropped."""
        self._stop.set()
        while True:
            try:
                self._out.get_nowait()
            except queue.Empty:
                break

    def __del__(self):
        self.close()
