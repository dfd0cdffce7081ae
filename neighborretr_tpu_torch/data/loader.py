"""Batch loader: threaded item assembly → fixed-shape global numpy batches.

Replaces the reference's torch DataLoader + DistributedSampler stack
(data_dataloaders.py:18-47): one GLOBAL batch is assembled per step and handed
to the jitted SPMD program, which shards it over the mesh's data axis at the
call boundary — there is no per-rank sampling to reconcile, and the eval-time
id-reordering dance (evaluator.py:173-189) disappears by construction.

Video decode (the reference's worker processes) runs on a thread pool by
default: cv2 releases the GIL inside decode, so threads scale like the
reference's workers without pickling overhead.  A one-batch prefetch overlaps
host decode with device compute.

`worker_mode="process"` switches to forked worker PROCESSES (the reference's
torch DataLoader num_workers model, data_dataloaders.py:36-47): the
Python-level work per item — RandAugment's per-op PIL orchestration, batch
dict assembly — holds the GIL, so on many-core TPU-VM hosts threads alone
plateau well below the chip's ~350 clips/s appetite.  Process workers pay
~2 MB/clip of result pickling but scale the Python cost across cores.
Workers fork at epoch start (each __iter__), inheriting the dataset
post-set_epoch; per-item state must come from item(i) alone (our datasets
derive per-item RNGs from (seed, epoch, index), so decode order or worker
assignment cannot change results).  Caption/LRU caches are per-worker in
this mode, as in the reference.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from queue import Queue
from typing import Dict, Iterator, Optional

import numpy as np

# Forked workers read the dataset from a module global installed by the pool
# initializer: task submissions then pickle only the item index, never the
# dataset (which may hold unpicklable caches/locks — fork inherits those).
_WORKER_DATASET = None


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_item(i: int):
    return _WORKER_DATASET.item(i)


def _stack(items) -> Dict[str, np.ndarray]:
    keys = items[0].keys()
    return {k: np.stack([it[k] for it in items], axis=0) for k in keys}


class BatchLoader:
    """Iterates fixed-shape global batches over a dataset.

    Args:
      dataset: object with __len__ and item(i) (see datasets/base.py).
      batch_size: GLOBAL batch size.
      shuffle: reshuffle each epoch (seeded, epoch-dependent).
      drop_last: drop the trailing partial batch (train) — eval pads instead
        via `pad_to_batch` so shapes stay static for jit.
      workers: decode threads (or forked processes, per worker_mode).
      worker_mode: "thread" (default; cv2 releases the GIL) or "process"
        (forked workers — scales Python-level augment cost across cores,
        the reference's DataLoader num_workers model).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, workers: int = 8, seed: int = 42,
                 pad_to_batch: bool = False, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 worker_mode: str = "thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(
                f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        self.worker_mode = worker_mode
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.workers = max(1, workers)
        self.seed = seed
        self.pad_to_batch = pad_to_batch
        self.prefetch = prefetch
        self.epoch = 0
        # Multi-host: every process runs this loader with the SAME seed and
        # epoch, derives the identical global batch plan, and assembles only
        # its contiguous row block (reference counterpart: DistributedSampler
        # per-rank shards, data_dataloaders.py:32-38).  Tensor keys come out
        # LOCAL ([batch/process_count, ...], matching this process's
        # addressable shards for make_array_from_process_local_data); the
        # host-only global_idx/global_valid keys carry the full batch plan so
        # eval bookkeeping needs no collectives.
        self.process_index = process_index
        self.process_count = max(1, process_count)
        if batch_size % self.process_count:
            raise ValueError(
                f"batch_size {batch_size} not divisible by process_count "
                f"{self.process_count}")
        if self.process_count > 1 and not (drop_last or pad_to_batch):
            raise ValueError(
                "multi-process loading requires drop_last (train) or "
                "pad_to_batch (eval) so every process sees full batches")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # datasets with epoch-dependent stochastic decoration (RandAugment /
        # frame shuffling) re-seed their per-item RNGs from this
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def skip_next_batches(self, k: int) -> None:
        """One-shot fast-forward: the NEXT ``__iter__`` starts at batch ``k``
        of its (seeded, epoch-dependent) plan.  Exact mid-epoch resume: the
        plan is a pure function of (seed, epoch), so skipping the batches a
        preempted run already consumed continues the identical stream —
        without decoding the skipped items."""
        if k < 0:
            raise ValueError(f"skip_next_batches: k must be >= 0, got {k}")
        self._skip_next = int(k)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        return order

    def _assemble(self, idxs, pool) -> Dict[str, np.ndarray]:
        idxs = np.asarray(idxs)
        real = len(idxs)
        if self.pad_to_batch and real < self.batch_size:
            # pad the GLOBAL plan (padded rows marked invalid via `valid`)
            g_idx = np.concatenate(
                [idxs, np.repeat(idxs[-1:], self.batch_size - real)])
        else:
            g_idx = idxs
        g_valid = np.concatenate(
            [np.ones(real, np.bool_),
             np.zeros(len(g_idx) - real, np.bool_)])

        per = len(g_idx) // self.process_count
        lo = self.process_index * per
        local_idx = g_idx[lo:lo + per]

        # fetch each unique index once: pad slots repeat the last real index
        # and must not re-decode its video per slot
        uniq, inv = np.unique(local_idx, return_inverse=True)
        if isinstance(pool, cf.ProcessPoolExecutor):
            fetched = list(pool.map(_worker_item, [int(u) for u in uniq]))
        else:
            fetched = list(pool.map(self.dataset.item, uniq))
        batch = _stack([fetched[j] for j in inv])
        batch["valid"] = g_valid[lo:lo + per]
        if self.process_count > 1:
            batch["global_idx"] = g_idx
            batch["global_valid"] = g_valid
        return batch

    def _make_pool(self):
        if self.worker_mode == "process":
            import multiprocessing as mp
            try:
                # fork only: the dataset reaches workers by memory
                # inheritance (initargs are not pickled under fork), so
                # caches/locks/open tokenizers survive; spawn would have to
                # pickle all of it.  Fork happens before the producer thread
                # starts, at epoch start.
                ctx = mp.get_context("fork")
            except ValueError:
                import logging
                logging.getLogger("neighborretr_tpu_torch").warning(
                    "worker_mode='process' needs the fork start method "
                    "(unavailable on this platform); using threads")
                return cf.ThreadPoolExecutor(self.workers)
            return cf.ProcessPoolExecutor(
                self.workers, mp_context=ctx,
                initializer=_worker_init, initargs=(self.dataset,))
        return cf.ThreadPoolExecutor(self.workers)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        n = len(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        slices = [order[i: i + self.batch_size]
                  for i in range(0, limit, self.batch_size)]
        skip = getattr(self, "_skip_next", 0)
        if skip:
            self._skip_next = 0
            slices = slices[skip:]

        pool = self._make_pool()
        if self.prefetch <= 0:
            try:
                for s in slices:
                    yield self._assemble(s, pool)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
            return

        # Early termination is normal (bounded memory-bank fills, benches,
        # generator GC) — the producer must never submit to a shut-down pool
        # or block forever on a full queue, so every put is stop-aware.
        from queue import Full
        q: Queue = Queue(maxsize=self.prefetch)
        stop = object()
        stopping = threading.Event()

        def _put(item) -> bool:
            while not stopping.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def producer():
            # Dataset/decode errors must reach the consumer: swallowing them
            # here would end iteration cleanly after a TRUNCATED epoch (short
            # training epoch, eval metrics over a partial feature cache).
            # The exception rides the queue and is re-raised in the consumer
            # — unless the consumer already initiated shutdown, in which case
            # errors from the dying pool are expected noise.
            try:
                for s in slices:
                    if stopping.is_set():
                        return
                    if not _put(self._assemble(s, pool)):
                        return
            except BaseException as e:       # noqa: BLE001 — re-raised below
                if not stopping.is_set():
                    _put(e)
                return
            finally:
                _put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stopping.set()
            t.join()
            pool.shutdown(wait=False, cancel_futures=True)
