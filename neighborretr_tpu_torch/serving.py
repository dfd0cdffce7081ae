"""Retrieval serving: precomputed video index + free-text top-k search
(↔ neighborretr_tpu/serving.py).

The index file is the JAX package's own npz layout, so an index built by
either package loads and verifies in the other:

  video_ids [N]      video ids (dataset order, deduplicated)
  v_feat    [N,F,E]  temporal video features, fp16 (or int8 with
                     per-(video, frame) scales in v_scale [N,F] fp16)
  v_mask    [N,F]    frame validity
  meta      json     model config + weights fingerprint

A `Searcher` keeps the corpus on the model's device across requests;
`BatchingDispatcher` merges concurrent requests into one device call, and
`cli/serve.py` puts both behind HTTP with a live `/reload`.

Sharded mode (↔ the JAX package's mesh branches), in one process over a
list of devices: `build_video_index(devices=)` splits each encode batch's
rows over the devices, and `Searcher(devices=)` splits the corpus rows
(padded to a multiple of the device count) into one shard per device, runs
the similarity per shard on the shard's device and merges the shards'
top-k.  A device listed twice holds two shards (one model copy serves
both).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.config import Config
from .data.text import encode_caption

from .eval import (encode_text_batch, encode_video_batch,
                   similarity_matrix_device)
from .models.neighborretr import NeighborRetr, similarity_kernels
from .utils.spans import span

# the same three leaves, under the JAX package's path names and in its
# byte layout (fp32, [width, embed] projections), as serving.params_fingerprint
_FINGERPRINT_LEAVES = ((("clip", "logit_scale"), "clip.logit_scale"),
                       (("clip", "text", "text_projection"),
                        "clip.text_projection"),
                       (("clip", "visual", "proj"), "clip.visual.proj"))


def params_fingerprint(model: NeighborRetr) -> str:
    """Hash of a few weight tensors; equal to the JAX package's
    params_fingerprint for the same weights."""
    sd = model.state_dict()
    h = hashlib.blake2b(digest_size=16)
    for path, name in _FINGERPRINT_LEAVES:
        h.update("/".join(path).encode())
        leaf = sd[name].detach().cpu().float().numpy()
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def _config_meta(cfg: Config, model: Optional[NeighborRetr] = None
                 ) -> Dict[str, Any]:
    m = cfg.model
    meta = {"embed_dim": m.clip.embed_dim, "max_words": m.max_words,
            "max_frames": m.max_frames,
            "image_resolution": m.clip.image_resolution}
    if model is not None:
        meta["params_fingerprint"] = params_fingerprint(model)
    return meta


def quantize_features(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 with a per-token absmax scale: v ≈ q · scale[..., None]."""
    scale = np.abs(v).max(axis=-1, keepdims=True).astype(np.float32) / 127.0
    scale = np.maximum(scale, 1e-8)
    q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
    return q, scale[..., 0].astype(np.float16)


def device_scope(device):
    """Make `device` the thread's current CUDA device (the current device
    and stream are per thread: a handler or dispatcher thread starts on
    device 0's default stream); a no-op for the CPU."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def staged_device_put(a: np.ndarray, rows: int, device,
                      yield_fn=None) -> torch.Tensor:
    """H2D upload in row slabs instead of one transfer (↔ serving.
    staged_device_put): the buffer is allocated once on the device in
    a's dtype, each slab is copied from a pinned host chunk, and `yield_fn`
    (default: a GIL yield) runs between slabs, so searches from other
    threads interleave with a live reload's upload.  rows <= 0, or a single
    slab that holds every row, is one copy.  A slab count that does not
    divide the rows ends on an overlapping slab of the same shape."""
    dev = torch.device(device)
    n = a.shape[0]
    if rows <= 0 or rows >= n:
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    buf = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                      device=dev)
    offsets = list(range(0, n - rows + 1, rows))
    if offsets[-1] + rows < n:
        offsets.append(n - rows)
    pinned = dev.type == "cuda"
    for off in offsets:
        chunk = torch.from_numpy(np.ascontiguousarray(a[off:off + rows]))
        if pinned:
            # the caching host allocator keeps a pinned chunk alive until
            # the copy that reads it has run
            chunk = chunk.pin_memory()
        buf[off:off + rows].copy_(chunk, non_blocking=pinned)
        if yield_fn is not None:
            yield_fn()
        else:
            time.sleep(0)
    return buf


def index_video_features(index: Dict[str, np.ndarray], device,
                         staged_rows: int = 0,
                         yield_fn=None) -> torch.Tensor:
    """fp32 device view of the stored features.  The upload crosses in the
    stored dtype (fp16/int8) and widens on the device; with staged_rows > 0
    it goes up in row slabs (`staged_device_put`), on a CUDA device on a
    side stream that the current stream then waits for, so work queued
    meanwhile on the current stream does not wait behind the copies."""
    dev = torch.device(device)
    side = (torch.cuda.Stream(dev) if staged_rows > 0 and dev.type == "cuda"
            else None)
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side) if side is not None else \
            contextlib.nullcontext():
        q = staged_device_put(np.asarray(index["v_feat"]), staged_rows, dev,
                              yield_fn)
        if "v_scale" in index:
            s = torch.as_tensor(np.asarray(index["v_scale"]), device=dev)
            feat = q.float() * s.float()[..., None]
        else:
            feat = q.float()
    if side is not None:
        main = torch.cuda.current_stream(dev)
        main.wait_stream(side)
        # allocated on the side stream, read on the main one from now on
        feat.record_stream(main)
    return feat


def model_replicas(model: NeighborRetr, devices) -> List[NeighborRetr]:
    """The model on each of `devices`: the model itself on its own device,
    one copy per other distinct device."""
    own = model.clip.logit_scale.device
    copies = {own: model}
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d not in copies:
            copies[d] = copy.deepcopy(model).to(d)
        out.append(copies[d])
    return out


def build_video_index(model: NeighborRetr, cfg: Config, loader,
                      dataset=None, logger=None,
                      feature_dtype: str = "float16", skip_ids=None,
                      kernels: bool = True,
                      devices: Optional[Sequence] = None
                      ) -> Dict[str, np.ndarray]:
    """Encode every unique video the loader yields (deduplicated by the
    per-video hash; multi-sentence datasets repeat each video per caption),
    gathering the unique rows before the ViT forward.  devices: split each
    encode batch's rows over these devices (data-parallel corpus
    encoding; the loader's batch size must divide over them)."""
    if feature_dtype not in ("float16", "int8"):
        raise ValueError(f"feature_dtype must be float16 or int8, "
                         f"got {feature_dtype!r}")
    replicas = model_replicas(model, devices) if devices else [model]
    skip_ids = frozenset(skip_ids or ())
    dataset = dataset if dataset is not None else loader.dataset
    pairs = getattr(dataset, "pairs", None)
    seen = set()
    feats, masks, ids = [], [], []
    for batch in loader:
        keep = []
        for i, (row, ok) in enumerate(zip(batch["idx"], batch["valid"])):
            h = int(batch["video_hash"][i])
            if not ok or h in seen:
                continue
            vid = (pairs[int(row)][0] if pairs is not None
                   else f"video{int(row)}")
            if vid in skip_ids:
                continue
            seen.add(h)
            keep.append(i)
            ids.append(vid)
        if not keep:
            continue
        B = batch["video"].shape[0]
        if B % len(replicas):
            raise ValueError(f"an encode batch of {B} rows does not split "
                             f"over {len(replicas)} devices")
        gather = np.asarray(keep + [keep[0]] * (B - len(keep)))
        per = B // len(replicas)
        blocks = [encode_video_batch(m, batch["video"][gather[i:i + per]],
                                     batch["video_mask"][gather[i:i + per]],
                                     kernels)
                  for m, i in zip(replicas, range(0, B, per))]
        vf = torch.cat([b.cpu() for b in blocks])
        feats.append(vf[:len(keep)].numpy().astype(np.float16))
        masks.append(np.asarray(batch["video_mask"], np.float32)[keep])
        if logger is not None:
            logger.info("Indexed %d videos", len(ids))
    if not feats:
        raise ValueError(
            "no valid videos to index: the loader yielded nothing (empty "
            "split, or every row failed decoding)")
    index = {"video_ids": np.asarray(ids),
             "v_feat": np.concatenate(feats),
             "v_mask": np.concatenate(masks),
             "meta": np.frombuffer(
                 json.dumps(_config_meta(cfg, model)).encode(),
                 dtype=np.uint8)}
    if feature_dtype == "int8":
        index["v_feat"], index["v_scale"] = quantize_features(index["v_feat"])
    return index


def append_index(existing: Dict[str, np.ndarray],
                 new: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Merge a freshly built index into an existing one (↔ serving.
    append_index).  Both must come from the same config and weights
    (byte-equal meta) and the same feature dtype layout; rows of `new`
    whose video id is already there are dropped."""
    if existing["meta"].tobytes() != new["meta"].tobytes():
        raise ValueError(
            "cannot append: the existing index was built with a different "
            "model config or checkpoint (meta mismatch) — rebuild instead")
    if ("v_scale" in existing) != ("v_scale" in new):
        raise ValueError("cannot append: feature_dtype differs from the "
                         "existing index (int8 vs float16)")
    have = {str(v) for v in existing["video_ids"]}
    fresh = [i for i, v in enumerate(new["video_ids"]) if str(v) not in have]
    if not fresh:
        return existing
    out = {"meta": existing["meta"]}
    for key in ("video_ids", "v_feat", "v_mask") + (
            ("v_scale",) if "v_scale" in existing else ()):
        out[key] = np.concatenate([existing[key], new[key][fresh]])
    return out


def index_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_index(path: str, index: Dict[str, np.ndarray]) -> str:
    """Atomic write (temp file + rename); returns the path written."""
    path = index_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:   # a file object: savez adds no suffix
            np.savez(f, **index)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def load_index(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def check_meta(index: Dict[str, np.ndarray], cfg: Config,
               model: Optional[NeighborRetr] = None) -> None:
    """Reject an index built with another model config or, when `model` is
    given, with other weights."""
    if "meta" not in index:
        raise ValueError(
            "index has no 'meta' entry — not produced by build_video_index "
            "(or truncated); refusing to score against an unverifiable index")
    stored = json.loads(bytes(index["meta"].tobytes()).decode())
    current = _config_meta(cfg, model)
    mismatched = {k: (v, current[k]) for k, v in stored.items()
                  if k in current and k != "max_words" and current[k] != v}
    cfg_mismatch = {k: v for k, v in mismatched.items()
                    if k != "params_fingerprint"}
    if cfg_mismatch:
        raise ValueError(
            f"index was built with a different model config: {cfg_mismatch} "
            f"(index value, current value)")
    if "params_fingerprint" in mismatched:
        raise ValueError(
            "index was built with a DIFFERENT CHECKPOINT than the one loaded "
            "for this query (weights fingerprint mismatch) — rebuild the "
            "index with the current checkpoint")


def encode_queries(model: NeighborRetr, cfg: Config, tokenizer,
                   queries: Sequence[str], kernels: bool = True
                   ) -> Tuple[torch.Tensor, np.ndarray]:
    """Free-text queries → [Q, W, E] text features on the model's device +
    [Q, W] mask (the datasets' SOT/EOT/truncate/pad pipeline)."""
    with span("nr::search.tokenise"):
        enc = [encode_caption(tokenizer, q, cfg.model.max_words)
               for q in queries]
        ids = np.stack([e[0] for e in enc])
        mask = np.stack([e[1] for e in enc])
    with span("nr::search.text"):
        return encode_text_batch(model, ids, mask, kernels), mask


def masked_topk(sim: torch.Tensor, kk: int, n_valid: int):
    """Device top-k over the first n_valid columns (pad columns → -inf);
    sorted descending."""
    if n_valid < sim.shape[1]:
        sim = sim.clone()
        sim[:, n_valid:] = -torch.inf
    return torch.topk(sim, kk, dim=1, largest=True, sorted=True)


class Searcher:
    """Query engine over a loaded index: the corpus features live on the
    model's device across requests, and query batches pad up to a multiple
    of `query_batch` ("" queries, rows dropped).  staged_upload_rows > 0
    uploads the corpus in row slabs on a side stream (the live reload
    path, `index_video_features`).

    devices: shard the corpus over these devices (↔ the JAX Searcher's
    mesh): N rows padded with copies of row 0 up to a multiple of the
    device count (the pad columns are ranked out), one contiguous shard a
    device, the similarity run per shard on its device and the shards'
    top-k merged; queries are encoded once, on the first device.  Each
    shard's upload is staged under staged_upload_rows > 0 (the JAX mesh
    branch ignores that argument; the port does not copy that)."""

    def __init__(self, model: NeighborRetr, cfg: Config,
                 index: Dict[str, np.ndarray], tokenizer,
                 query_batch: int = 8, kernels: bool = True,
                 staged_upload_rows: int = 0,
                 devices: Optional[Sequence] = None):
        if query_batch < 1:
            raise ValueError(f"query_batch must be >= 1, got {query_batch}")
        check_meta(index, cfg, model)
        self.cfg, self.tokenizer = cfg, tokenizer
        self.kernels = kernels
        self.video_ids = [str(v) for v in index["video_ids"]]
        self.query_batch = int(query_batch)
        replicas = (model_replicas(model, devices) if devices
                    else [model])
        self.model = replicas[0]
        self.device = self.model.clip.logit_scale.device
        self.calls = 0           # device calls made (text encode + K2)
        n, S = len(self.video_ids), len(replicas)
        pad = (-n) % S
        rows = {k: index[k] for k in ("v_feat", "v_scale") if k in index}
        rows["v_mask"] = np.asarray(index["v_mask"], np.float32)
        if pad:
            rows = {k: np.concatenate([v, np.repeat(v[:1], pad, 0)])
                    for k, v in rows.items()}
        per = (n + pad) // S
        # (model, features, mask, first corpus row) per shard
        self._shards = []
        for i, m in enumerate(replicas):
            dev = m.clip.logit_scale.device
            part = {k: v[i * per:(i + 1) * per] for k, v in rows.items()}
            with device_scope(dev):
                feat = index_video_features(part, dev,
                                            staged_rows=staged_upload_rows)
                mask = torch.as_tensor(part["v_mask"], device=dev)
            self._shards.append((m, feat, mask, i * per))

    def __len__(self) -> int:
        return len(self.video_ids)

    def warmup(self) -> None:
        """Pay, before the first request, for what it would wait on: the
        kernel libraries' build and load (ops/_build.py), the cuBLAS
        handles, the allocator's first blocks (the daemon calls this
        before binding its port)."""
        self.search(["warmup"], topk=1)
        self.similarities(["warmup"])

    @torch.no_grad()
    def _similarity(self, queries: Sequence[str]) -> List[torch.Tensor]:
        """Per shard, the device [Q_padded, N_shard] similarity for a
        padded query list."""
        padded = list(queries) + [""] * ((-len(queries)) % self.query_batch)
        self.calls += 1
        t_feat, t_mask = encode_queries(self.model, self.cfg, self.tokenizer,
                                        padded, self.kernels)
        kernels = similarity_kernels(self.cfg.model, self.kernels)
        sims = []
        with span("nr::search.similarity"):
            for m, feat, mask, _ in self._shards:
                dev = feat.device
                with device_scope(dev):
                    sims.append(similarity_matrix_device(
                        m, t_feat.to(dev), t_mask, feat, mask,
                        kernels=kernels))
        return sims

    def similarities(self, queries: Sequence[str]) -> np.ndarray:
        """[Q, N] similarity rows for free-text queries."""
        n = len(queries)
        if n == 0:
            return np.zeros((0, len(self.video_ids)), np.float32)
        with device_scope(self.device):
            sims = self._similarity(queries)
            return torch.cat([s[:n].cpu() for s in sims],
                             dim=1)[:, :len(self.video_ids)].numpy()

    def search(self, queries: Sequence[str], topk: int = 5,
               ) -> List[List[Tuple[str, float]]]:
        """Top-k videos per query, [(video_id, similarity), ...]; the top-k
        runs on the device and only [Q, k] crosses to the host."""
        n = len(queries)
        k = max(min(topk, len(self.video_ids)), 0)
        if n == 0 or k == 0:
            return [[] for _ in queries]
        with device_scope(self.device), span("nr::search"):
            sims = self._similarity(queries)
            with span("nr::search.topk"):
                # k bucketed to the next power of two, min 8, as the JAX
                # searcher does to reuse its compiled top-k programs
                if len(sims) == 1:
                    kk = min(max(8, 1 << (k - 1).bit_length()),
                             sims[0].shape[1])
                    vals, idx = masked_topk(sims[0], kk, len(self.video_ids))
                else:
                    vals, idx = self._merged_topk(sims, k)
                vals = vals[:n, :k].cpu().numpy()
                idx = idx[:n, :k].cpu().numpy()
        return [[(self.video_ids[j], float(v)) for j, v in zip(irow, vrow)]
                for irow, vrow in zip(idx, vals)]


    def _merged_topk(self, sims: List[torch.Tensor], k: int):
        """Top-k over the shards: each shard's top-k (its pad columns
        ranked out) with its column offset, merged on the first device."""
        n_valid = len(self.video_ids)
        vals, idx = [], []
        for sim, (_, _, _, first) in zip(sims, self._shards):
            valid = min(max(n_valid - first, 0), sim.shape[1])
            v, i = masked_topk(sim, min(k, sim.shape[1]), valid)
            vals.append(v.to(self.device))
            idx.append(i.to(self.device) + first)
        v, j = torch.topk(torch.cat(vals, dim=1), k, dim=1, largest=True,
                          sorted=True)
        return v, torch.gather(torch.cat(idx, dim=1), 1, j)


def search(model: NeighborRetr, cfg: Config, index: Dict[str, np.ndarray],
           tokenizer, queries: Sequence[str], topk: int = 5,
           kernels: bool = True) -> List[List[Tuple[str, float]]]:
    """One-shot top-k search; daemons keep a Searcher."""
    return Searcher(model, cfg, index, tokenizer,
                    query_batch=max(len(queries), 1),
                    kernels=kernels).search(queries, topk)


class _Pending:
    __slots__ = ("queries", "topk", "event", "results", "error", "submitted")

    def __init__(self, queries: Sequence[str], topk: int):
        self.submitted = time.perf_counter()
        self.queries = list(queries)
        self.topk = int(topk)
        self.event = threading.Event()
        self.results = None
        self.error: Optional[BaseException] = None


class BatchingDispatcher:
    """Cross-request dynamic batching over one Searcher (↔ serving.
    BatchingDispatcher).

    The daemon's handler threads each carry one request; this dispatcher
    merges whatever is queued (waiting at most `max_wait_ms` after the first
    arrival, up to `max_batch` queries, the merge rounded up to a
    power-of-two multiple of the searcher's `query_batch` with "" queries)
    into ONE `searcher.search` call at the batch's largest topk, then hands
    each request its own rows at its own topk.  A request that would push
    the merge past `max_batch` starts the next batch, so a batch exceeds it
    only when a single request does.  An error in the device call reaches
    every co-batched caller; `close()` fails whatever is still queued.

    The dispatcher's thread makes the searcher's device its current one
    before each call (`device_scope`): the current CUDA device and stream
    belong to a thread.  `searcher` may be swapped (the daemon's /reload).

    Counters: `batches` (device calls), `requests` (requests served) and
    `queue_wait_s`, the seconds the served requests waited from `submit`
    to the hand-off of their merged batch to the searcher."""

    def __init__(self, searcher, max_batch: Optional[int] = None,
                 max_wait_ms: float = 2.0):
        if max_batch is not None and max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.searcher = searcher
        self.max_batch = int(max_batch or max(searcher.query_batch * 8, 64))
        self.max_wait = max(float(max_wait_ms), 0.0) / 1e3
        qb = int(searcher.query_batch)
        self.buckets = []
        b = qb
        while b < self.max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(self.max_batch)
        self._queue: "queue.SimpleQueue[Optional[_Pending]]" = \
            queue.SimpleQueue()
        self._carry: Optional[_Pending] = None   # dequeued but over the cap
        self._closed = False
        self.batches = 0
        self.requests = 0
        self.queue_wait_s = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="nrtpu-serve-batcher")
        self._thread.start()

    def submit(self, queries: Sequence[str], topk: int
               ) -> List[List[Tuple[str, float]]]:
        if self._closed:
            raise RuntimeError("BatchingDispatcher is closed")
        p = _Pending(queries, topk)
        self._queue.put(p)
        # bounded waits: a submit racing close() must raise, not hang
        while not p.event.wait(timeout=1.0):
            if self._closed and not p.event.is_set():
                raise RuntimeError("BatchingDispatcher closed mid-request")
        if p.error is not None:
            raise p.error
        return p.results

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=10)
        while True:              # fail whatever is still queued
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                p.error = RuntimeError("BatchingDispatcher closed")
                p.event.set()

    def _first(self) -> Optional[_Pending]:
        """The next batch's first request: the carried one, or the next in
        the queue, blocking while it is empty."""
        first = self._carry if self._carry is not None else self._queue.get()
        self._carry = None
        return first

    def _collect(self, first: _Pending) -> List[_Pending]:
        """One merged batch from its first request: drain the queue until
        max_batch or the window closes."""
        batch = [first]
        total = len(first.queries)
        deadline = time.monotonic() + self.max_wait
        while total < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._queue.get_nowait() if remaining <= 0
                       else self._queue.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is None:            # close() while a batch is forming:
                self._queue.put(None)  # serve it, exit on the next round
                break
            if total + len(nxt.queries) > self.max_batch:
                self._carry = nxt      # would overflow: starts the next batch
                break
            batch.append(nxt)
            total += len(nxt.queries)
        return batch

    def _loop(self) -> None:
        while True:
            with span("nr::dispatch.wait"):
                first = self._first()
            if first is None:
                return
            with span("nr::dispatch.merge"):
                batch = self._collect(first)
                merged: List[str] = []
                for p in batch:
                    merged.extend(p.queries)
                n_real = len(merged)
                for b in self.buckets:       # round up to a bucket
                    if b >= n_real:
                        merged.extend([""] * (b - n_real))
                        break
            searcher = self.searcher
            handed = time.perf_counter()
            try:
                with device_scope(getattr(searcher, "device", None)):
                    hits = searcher.search(merged,
                                           topk=max(p.topk for p in batch))
                off = 0
                for p in batch:
                    rows = hits[off:off + len(p.queries)]
                    p.results = [row[:p.topk] for row in rows]
                    off += len(p.queries)
            except BaseException as exc:  # noqa: BLE001 — to every waiter
                for p in batch:
                    p.error = exc
            finally:
                self.batches += 1
                self.requests += len(batch)
                self.queue_wait_s += sum(handed - p.submitted for p in batch)
                for p in batch:
                    p.event.set()
