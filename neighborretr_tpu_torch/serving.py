"""Retrieval serving: precomputed video index + free-text top-k search
(↔ neighborretr_tpu/serving.py).

The index file is the JAX package's own npz layout, so an index built by
either package loads and verifies in the other:

  video_ids [N]      video ids (dataset order, deduplicated)
  v_feat    [N,F,E]  temporal video features, fp16 (or int8 with
                     per-(video, frame) scales in v_scale [N,F] fp16)
  v_mask    [N,F]    frame validity
  meta      json     model config + weights fingerprint

The dynamic-batching dispatcher and the HTTP daemon are not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.config import Config
from .data.text import encode_caption

from .eval import (encode_text_batch, encode_video_batch,
                   similarity_matrix_device)
from .models.neighborretr import NeighborRetr, similarity_kernels

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


def index_video_features(index: Dict[str, np.ndarray],
                         device) -> torch.Tensor:
    """fp32 device view of the stored features.  The upload crosses in the
    stored dtype (fp16/int8) and widens on the device."""
    q = torch.as_tensor(np.asarray(index["v_feat"]), device=device)
    if "v_scale" in index:
        s = torch.as_tensor(np.asarray(index["v_scale"]), device=device)
        return q.float() * s.float()[..., None]
    return q.float()


def build_video_index(model: NeighborRetr, cfg: Config, loader,
                      dataset=None, logger=None,
                      feature_dtype: str = "float16", skip_ids=None,
                      kernels: bool = True) -> Dict[str, np.ndarray]:
    """Encode every unique video the loader yields (deduplicated by the
    per-video hash; multi-sentence datasets repeat each video per caption),
    gathering the unique rows before the ViT forward."""
    if feature_dtype not in ("float16", "int8"):
        raise ValueError(f"feature_dtype must be float16 or int8, "
                         f"got {feature_dtype!r}")
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
        gather = np.asarray(keep + [keep[0]] * (B - len(keep)))
        vf = encode_video_batch(model, batch["video"][gather],
                                batch["video_mask"][gather], kernels)
        feats.append(vf[:len(keep)].cpu().numpy().astype(np.float16))
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
    enc = [encode_caption(tokenizer, q, cfg.model.max_words) for q in queries]
    ids = np.stack([e[0] for e in enc])
    mask = np.stack([e[1] for e in enc])
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
    of `query_batch` ("" queries, rows dropped)."""

    def __init__(self, model: NeighborRetr, cfg: Config,
                 index: Dict[str, np.ndarray], tokenizer,
                 query_batch: int = 8, kernels: bool = True):
        if query_batch < 1:
            raise ValueError(f"query_batch must be >= 1, got {query_batch}")
        check_meta(index, cfg, model)
        self.model, self.cfg, self.tokenizer = model, cfg, tokenizer
        self.kernels = kernels
        self.video_ids = [str(v) for v in index["video_ids"]]
        self.query_batch = int(query_batch)
        dev = model.clip.logit_scale.device
        self._v_feat = index_video_features(index, dev)
        self._v_mask = torch.as_tensor(np.asarray(index["v_mask"], np.float32),
                                       device=dev)

    def _similarity(self, queries: Sequence[str]) -> torch.Tensor:
        """Device [Q_padded, N] similarity for a padded query list."""
        padded = list(queries) + [""] * ((-len(queries)) % self.query_batch)
        t_feat, t_mask = encode_queries(self.model, self.cfg, self.tokenizer,
                                        padded, self.kernels)
        return similarity_matrix_device(
            self.model, t_feat, t_mask, self._v_feat, self._v_mask,
            kernels=similarity_kernels(self.cfg.model, self.kernels))

    def similarities(self, queries: Sequence[str]) -> np.ndarray:
        """[Q, N] similarity rows for free-text queries."""
        n = len(queries)
        if n == 0:
            return np.zeros((0, len(self.video_ids)), np.float32)
        return self._similarity(queries)[:n].cpu().numpy()

    def search(self, queries: Sequence[str], topk: int = 5,
               ) -> List[List[Tuple[str, float]]]:
        """Top-k videos per query, [(video_id, similarity), ...]; the top-k
        runs on the device and only [Q, k] crosses to the host."""
        n = len(queries)
        k = max(min(topk, len(self.video_ids)), 0)
        if n == 0 or k == 0:
            return [[] for _ in queries]
        sim = self._similarity(queries)
        # k bucketed to the next power of two, min 8, as the JAX searcher
        # does to reuse its compiled top-k programs
        kk = min(max(8, 1 << (k - 1).bit_length()), sim.shape[1])
        vals, idx = masked_topk(sim, kk, len(self.video_ids))
        vals = vals[:n, :k].cpu().numpy()
        idx = idx[:n, :k].cpu().numpy()
        return [[(self.video_ids[j], float(v)) for j, v in zip(irow, vrow)]
                for irow, vrow in zip(idx, vals)]


def search(model: NeighborRetr, cfg: Config, index: Dict[str, np.ndarray],
           tokenizer, queries: Sequence[str], topk: int = 5,
           kernels: bool = True) -> List[List[Tuple[str, float]]]:
    """One-shot top-k search; daemons keep a Searcher."""
    return Searcher(model, cfg, index, tokenizer,
                    query_batch=max(len(queries), 1),
                    kernels=kernels).search(queries, topk)
