"""Pinned host memory, a copy stream per device, and events: the one
mechanism behind the device prefetch (data/device_prefetch.py), the
host-resident optimizer moments (train/bertadam.py) and the host-resident
memory bank (train/memory_bank.py).

A copy between pageable host memory and the card is synchronous for the
host and is ordered on the compute stream, so the card has nothing queued
while it runs.  Here every transfer is a `copy_(non_blocking=True)` between
pinned host memory and the card on a side stream of the device
(`copy_stream`), ordered against the compute stream by events:

  * host → device (`to_device`; the prefetch on a stream of its own): the
    compute stream waits for the copy before it reads the tensors, and
    each tensor is recorded as used on the compute stream, so the caching
    allocator does not hand its memory out while compute work is still
    queued on it;
  * device → host (`to_host`): the copy stream first waits for the compute
    stream (the values are final there), the device tensors are recorded
    as used on the copy stream, and nothing blocks the host.  The host
    copies are complete once `wait_copies` returns: call it before the host
    reads them (a checkpoint, a comparison).  A later `to_device` of the
    same tensors needs no wait: it runs on the same copy stream, after.

Nothing falls back: a pin, a stream or a copy that fails raises.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}


def require_cuda(device, what: str, jax_words: str) -> torch.device:
    """`device` as a torch.device; raises ValueError unless it is a CUDA
    device.  The message starts with the JAX package's words for the same
    refusal (`jax_words`), then says why here."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(
            f"{jax_words} (here: a CUDA device; {what} lives in pinned host "
            f"memory and moves on a copy stream, and a {device.type} device "
            "has neither)")
    return device


def copy_stream(device, purpose: str = "state") -> "torch.cuda.Stream":
    """The side stream of `device` that carries the host↔device copies of
    one purpose: "state" (moments, bank) or "batches" (the prefetch), so
    that a step waiting for its bank does not wait behind the next
    batch's upload."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = _STREAMS.get((device, purpose))
    if stream is None:
        stream = _STREAMS[(device, purpose)] = torch.cuda.Stream(
            device=device)
    return stream


def pinned(t: torch.Tensor) -> torch.Tensor:
    """`t` in pinned host memory (itself when it is pinned already)."""
    if t.device.type == "cpu" and t.is_pinned():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def to_device(tensors: Iterable[torch.Tensor], device) -> List[torch.Tensor]:
    """Device copies of pinned host tensors, issued on the copy stream; the
    current (compute) stream waits for them before its next kernel."""
    device = torch.device(device)
    compute = torch.cuda.current_stream(device)
    side = copy_stream(device)
    with torch.cuda.stream(side):
        out = [t.to(device, non_blocking=True) for t in tensors]
    compute.wait_stream(side)
    for t in out:
        t.record_stream(compute)
    return out


def to_host(tensors: Iterable[torch.Tensor], out=None) -> List[torch.Tensor]:
    """Pinned host copies of device tensors (into `out`, pinned tensors of
    the same shapes and dtypes, when given), issued on the copy stream
    once the current stream has produced them; the host does not wait
    (`wait_copies` before reading them)."""
    tensors = list(tensors)
    if not tensors:
        return []
    device = tensors[0].device
    side = copy_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    if out is None:
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
               for t in tensors]
    with torch.cuda.stream(side):
        for dst, src in zip(out, tensors):
            dst.copy_(src, non_blocking=True)
            src.record_stream(side)
    return list(out)


def wait_copies() -> None:
    """Blocks until every copy issued on a copy stream has landed."""
    for stream in _STREAMS.values():
        stream.synchronize()


def is_host_resident(t: torch.Tensor) -> bool:
    return t.device.type == "cpu" and t.is_pinned()
