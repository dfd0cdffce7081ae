"""Dataset protocol and shared item assembly.

A dataset is a plain Python object exposing:
  * ``__len__`` — number of (caption, video) pairs,
  * ``item(i)`` — a dict of fixed-shape numpy arrays:
        text_ids   [W]  int32
        text_mask  [W]  float32
        video      [F, R, R, 3] uint8      (device normalizes)
        video_mask [F]  float32
        idx        ()   int32
        video_hash ()   int64
  * ``multi_sentence_per_video`` (bool) and, when True, ``cut_off_points`` /
    ``video_num`` / ``sentence_num`` for the multi-sentence eval protocol
    (dataloader_msvd_retrieval.py:108-136 semantics).

`video_hash` mirrors the reference's hash(video_id.replace("video","")) tag
(dataloader_retrieval.py:343) — a stable per-video int id here.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..augment import ClipLRUCache, create_random_augment, process_frame_order
from ..text import encode_caption
from ..tokenizer import ClipTokenizer
from ..video import decode_video_frames


def _mtime(path: str) -> float:
    """File mtime for the decode-cache key (stale-file invalidation,
    rawvideo_util.py:202-216); 0.0 when unreadable (the decode itself will
    surface the error)."""
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def discover_video_paths(video_path: str, id_set,
                         keep_extension_ids: bool = False) -> Dict[str, str]:
    """Walk `video_path` mapping stripped-extension filename → full path for
    ids in `id_set` (the shared os.walk idiom of the MSVD/DiDeMo/ActivityNet
    datasets).  With keep_extension_ids, raw filenames that are themselves
    annotation ids also map (some DiDeMo ids keep their extension)."""
    found: Dict[str, str] = {}
    for root, _, files in os.walk(video_path):
        for name in files:
            vid = ".".join(name.split(".")[:-1])
            if vid in id_set:
                found[vid] = os.path.join(root, name)
            elif keep_extension_ids and name in id_set:
                found[name] = os.path.join(root, name)
    return found


def warn_missing_videos(dataset: str, wanted, found: Dict[str, str],
                        dropped: bool) -> None:
    """Surface annotation↔file id mismatches at BUILD time instead of a
    silent truncated eval set (dropped=True) or a mid-epoch decode fallback
    (dropped=False).  Raises when NOTHING matched — that is a misconfigured
    --video_path, not a few corrupt files."""
    wanted = list(wanted)
    missing = [v for v in wanted if v not in found]
    if not missing:
        return
    log = logging.getLogger("neighborretr_tpu_torch")
    if len(missing) == len(wanted):
        raise ValueError(
            f"{dataset}: none of the {len(wanted)} annotated videos were "
            f"found under the video path — check --video_path (looked for "
            f"e.g. {missing[:3]})")
    action = ("dropped from the dataset" if dropped
              else "will decode to zero frames")
    log.warning("%s: %d/%d annotated videos have no file and %s (e.g. %s)",
                dataset, len(missing), len(wanted), action, missing[:5])


def stable_video_hash(video_id: str) -> np.int64:
    """Deterministic 63-bit id from the video id string (process-stable,
    unlike Python's randomized hash())."""
    h = 1125899906842597  # large prime; arbitrary-precision Python ints
    for ch in str(video_id):
        h = (h * 31 + ord(ch)) & 0x7FFFFFFFFFFFFFFF
    return np.int64(h)


class RetrievalDataset:
    """Caption-video pair dataset over parsed annotations."""

    def __init__(
        self,
        pairs: List[Tuple[str, str, Optional[float], Optional[float]]],
        video_paths: Dict[str, str],
        tokenizer: ClipTokenizer,
        max_words: int = 24,
        max_frames: int = 12,
        resolution: int = 224,
        video_framerate: int = 1,
        multi_sentence_per_video: bool = False,
        cut_off_points: Optional[List[int]] = None,
        is_train: bool = False,
        augment: Optional[str] = "rand-m7-n4-mstd0.5-inc1",
        augment_backend: str = "auto",
        frame_order: int = 0,
        cache_capacity: int = 0,
        seed: int = 0,
        packed_dir: str = "",
    ):
        self.pairs = pairs                  # (video_id, caption, start, end)
        self.video_paths = video_paths
        self.tokenizer = tokenizer
        self.max_words = max_words
        self.max_frames = max_frames
        self.resolution = resolution
        self.video_framerate = video_framerate
        self.multi_sentence_per_video = multi_sentence_per_video
        self.cut_off_points = cut_off_points or []
        self._text_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        # train-time clip RandAugment (dataloader_retrieval.py:154-158,
        # rawvideo_util.py:291-293) + frame-order + decode LRU cache
        self.is_train = is_train
        self.frame_order = frame_order
        self.seed = seed
        self._epoch = 0
        # backend "device" moves the RandAugment into the jitted train step
        # (ops/device_augment.py) — the host then emits raw uint8 frames and
        # this dataset applies no pixel-level augment at all
        self._augment = (create_random_augment(augment,
                                               backend=augment_backend)
                         if (is_train and augment
                             and augment_backend != "device") else None)
        self._clip_cache = ClipLRUCache(cache_capacity)
        # packed pre-decoded corpus (data/packed.py): clip reads become
        # page-cached memcpys; misses fall back to cv2 decode.  The reader
        # refuses an index sampled with different (frames, resolution, fps).
        self._packed = None
        if packed_dir:
            from ..packed import PackedReader
            self._packed = PackedReader(packed_dir)
            self._packed.check_compatible(max_frames, resolution,
                                          video_framerate)

    def set_epoch(self, epoch: int) -> None:
        """Epoch-dependent stochastic decoration: item-level RNGs derive
        from (seed, epoch, index) so augmentation re-samples every epoch,
        stays reproducible, and is thread-safe under the loader's pool
        (numpy Generators are not shareable across threads)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.pairs)

    @property
    def sentence_num(self) -> int:
        return len(self.pairs)

    @property
    def video_num(self) -> int:
        return len(self.cut_off_points) if self.multi_sentence_per_video else len(self.pairs)

    def text_item(self, i: int) -> Dict[str, np.ndarray]:
        _, caption, _, _ = self.pairs[i]
        if caption not in self._text_cache:
            self._text_cache[caption] = encode_caption(
                self.tokenizer, caption, self.max_words)
        ids, mask = self._text_cache[caption]
        return {"text_ids": ids, "text_mask": mask}

    def video_item(self, video_id: str, start=None, end=None,
                   rng: Optional[np.random.Generator] = None
                   ) -> Dict[str, np.ndarray]:
        cached = None
        if self._packed is not None:    # packed hit: decode fully skipped —
            from ..packed import clip_key   # works without the raw .mp4 tree
            cached = self._packed.get(clip_key(video_id, start, end))
        if cached is None:
            path = self.video_paths[video_id]
            if self._clip_cache.capacity > 0:
                key = (path, _mtime(path), self.max_frames, self.resolution,
                       self.video_framerate, start, end)
                cached = self._clip_cache.get(key)
                if cached is None:
                    cached = decode_video_frames(
                        path, self.max_frames, self.resolution,
                        self.video_framerate, start, end)
                    self._clip_cache.put(key, cached)
            else:  # cache off (the default): skip the stat()+lock round trip
                cached = decode_video_frames(
                    path, self.max_frames, self.resolution,
                    self.video_framerate, start, end)
        frames, mask = cached
        # Stochastic decoration applies to the VALID frames only — padding
        # stays zero (reference order: augment/shuffle the decoded frames,
        # THEN pad; rawvideo_util.py:291-371) and the prefix-contiguous mask
        # stays aligned with the content.  Runs AFTER cache retrieval so
        # every epoch re-samples ops.
        n_valid = int(mask.sum())
        if (self._augment is not None or self.frame_order) and n_valid > 0:
            if rng is None:
                # deterministic fallback for direct video_item() callers —
                # the (seed, epoch, id) contract holds even off item()'s path
                rng = np.random.default_rng(
                    (self.seed, self._epoch, int(stable_video_hash(video_id))))
            valid = frames[:n_valid]
            if self._augment is not None:
                valid = self._augment(valid, rng=rng)
            if self.frame_order:
                valid = process_frame_order(valid, self.frame_order, rng)
            frames = np.concatenate([valid, frames[n_valid:]], axis=0)
        return {"video": frames, "video_mask": mask}

    def item(self, i: int) -> Dict[str, np.ndarray]:
        video_id, _, start, end = self.pairs[i]
        out = self.text_item(i)
        rng = np.random.default_rng((self.seed, self._epoch, i))
        out.update(self.video_item(video_id, start, end, rng=rng))
        out["idx"] = np.int32(i)
        out["video_hash"] = stable_video_hash(video_id.replace("video", ""))
        return out
