"""Host → device batch prefetch (↔
neighborretr_tpu/data/device_prefetch.py).

A loader batch moved with `torch.as_tensor(x).to(device)` from pageable
numpy memory is copied on the compute stream: the copy waits for the
previous step's kernels, then blocks the host until the bytes land, and the
card has nothing queued meanwhile (231 MB of uint8 frames a step at the
MSR-VTT recipe, 1.23 GB at 64 frames).  This iterator keeps `size` batches
in flight instead, as the JAX package's deque does: it enqueues `size`
batches before the first yield, then one per yield, so while step N runs,
batches N+1..N+size are already streaming to the card.

On a CUDA device each enqueued batch is a job of one background thread:
it takes the batch from the source iterator, copies each array into a
pinned host slot (the host copy happens there, not on the launching
thread), and issues the slot's upload on the device's "batches" copy
stream (utils/host_memory.py) with `non_blocking=True`, then records an
event.  The yield makes the compute stream wait for that event and records
each tensor as used on the compute stream (the tensors were allocated on
the copy stream, and the caching allocator must not reuse their memory
while the step's kernels are queued on it).  A slot is refilled only once
its upload's event has completed.  On a CPU device, which only a caller
that asks for the CPU gets, each batch is converted with the same
look-ahead and no thread.  A data rank prefetches its own block (its
loader yields only that) to its own device.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

# the keys a train step reads
BATCH_KEYS = ("text_ids", "text_mask", "video", "video_mask", "idx")


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy arrays or tensors) on `device`, copied now."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS}


def prefetch_to_device(iterator: Iterable[Dict], size: int = 2, device=None,
                       mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host-batch iterator (dicts of numpy arrays or tensors),
    keeping `size` transfers in flight; yields dicts of `BATCH_KEYS` on
    `device` (default: the mesh's device, else the CUDA device)."""
    if device is None:
        device = mesh.device if mesh is not None else "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        return _cuda_prefetch(iterator, max(size, 1), device)
    return _host_prefetch(iterator, max(size, 1), device)


def _host_prefetch(iterator, size, device):
    queue: collections.deque = collections.deque()
    it = iter(iterator)

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            queue.append(to_device(batch, device))

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)


class _Slot:
    """One batch's pinned host buffers and the event of their upload."""

    def __init__(self):
        self.host: Dict[str, torch.Tensor] = {}
        self.uploaded: Optional[torch.cuda.Event] = None

    def fill(self, batch) -> None:
        if self.uploaded is not None:
            self.uploaded.synchronize()      # the last upload has read it
        for k in BATCH_KEYS:
            src = torch.as_tensor(np.asarray(batch[k]))
            buf = self.host.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = self.host[k] = torch.empty(src.shape, dtype=src.dtype,
                                                 pin_memory=True)
            buf.copy_(src)


def _cuda_prefetch(iterator, size, device):
    from ..utils.host_memory import copy_stream

    stream = copy_stream(device, "batches")
    slots = [_Slot() for _ in range(size)]
    it = iter(iterator)
    pool = cf.ThreadPoolExecutor(1, thread_name_prefix="device-prefetch")
    queue: collections.deque = collections.deque()
    n_jobs = [0]

    def job(slot: _Slot):
        """Runs on the pool's one thread, one job after another."""
        try:
            batch = next(it)
        except StopIteration:
            return None
        slot.fill(batch)
        with torch.cuda.stream(stream):
            out = {k: v.to(device, non_blocking=True)
                   for k, v in slot.host.items()}
            slot.uploaded = torch.cuda.Event()
            slot.uploaded.record(stream)
        return out, slot.uploaded

    def enqueue(n: int) -> None:
        for _ in range(n):
            queue.append(pool.submit(job, slots[n_jobs[0] % size]))
            n_jobs[0] += 1

    try:
        enqueue(size)
        while queue:
            got = queue.popleft().result()
            if got is None:
                break
            batch, uploaded = got
            compute = torch.cuda.current_stream(device)
            compute.wait_event(uploaded)
            for t in batch.values():
                t.record_stream(compute)
            yield batch
            enqueue(1)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        close = getattr(it, "close", None)
        if close is not None:
            close()
