"""Packed pre-decoded clip corpus: decode once, mmap forever.

A from-files measurement showed the host input path is the last
reference-era subsystem: cv2 seek+decode costs 82.5 of 97.4 ms/clip/core
against a ~3 ms/pair chip appetite (PARITY.md "From-files").  The reference
has the same design — DataLoader workers re-decode every epoch
(data_dataloaders.py:36-47, rawvideo_util.py:249-283) — so parity never
required better, but a TPU-class pipeline does: this module stores the
DECODED, frame-sampled, resized uint8 clips in mmap-able shards so the
per-epoch host cost drops from a video decode to a page-cached memcpy.
RandAugment still runs per epoch on the loaded frames (the stochastic
decoration must re-sample; only the deterministic decode is cached).

On-disk layout (`<packed_dir>/`):
  index.json                      — meta + clip key → (shard, slot, n_valid)
  shard_00000.u8, shard_00001.u8  — raw C-order uint8 [K, F, R, R, 3]

A clip is keyed by (video_id, start, end) — paragraph datasets
(DiDeMo/ActivityNet) sample per-caption windows, so the window is part of
the identity.  Fixed slot size (max_frames * R * R * 3 bytes) makes every
shard a plain np.memmap; the OS page cache turns repeated epochs into
memory reads.  Meta records the sampling parameters; the reader refuses an
index whose (max_frames, resolution, video_framerate) disagree with the
dataset's — silently serving differently-sampled frames would be a wrong
result, not a slow one.

Built by cli/pack_dataset.py; consumed via RetrievalDataset(packed_dir=...).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

INDEX_NAME = "index.json"
FORMAT_VERSION = 1


def clip_key(video_id: str, start=None, end=None) -> str:
    """Stable identity of a packed clip: id + optional caption window."""
    s = "" if start is None else repr(float(start))
    e = "" if end is None else repr(float(end))
    return f"{video_id}|{s}|{e}"


def _slot_shape(meta: Dict) -> Tuple[int, int, int, int]:
    f, r = int(meta["max_frames"]), int(meta["resolution"])
    return (f, r, r, 3)


class PackedWriter:
    """Appends fixed-shape uint8 clips into rolling shard files.

    Not thread-safe by design — the packer decodes in parallel but writes
    from one thread (ordering the index is what makes packing reproducible).
    """

    def __init__(self, out_dir: str, max_frames: int, resolution: int,
                 video_framerate: int, clips_per_shard: int = 256):
        if clips_per_shard <= 0:
            raise ValueError("clips_per_shard must be positive")
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.meta = {"max_frames": int(max_frames),
                     "resolution": int(resolution),
                     "video_framerate": int(video_framerate)}
        self.clips_per_shard = clips_per_shard
        self.clips: Dict[str, Tuple[int, int, int]] = {}
        self.shards = []            # [{"file": name, "count": K}]
        self._fh = None
        self._closed = False

    def _shard_file(self):
        if self._fh is None or self.shards[-1]["count"] >= self.clips_per_shard:
            if self._fh is not None:
                self._fh.close()
            name = f"shard_{len(self.shards):05d}.u8"
            self._fh = open(os.path.join(self.out_dir, name), "wb")
            self.shards.append({"file": name, "count": 0})
        return self._fh

    def add(self, key: str, frames: np.ndarray, n_valid: int) -> None:
        """frames: uint8 [max_frames, R, R, 3] (padding rows zero);
        n_valid: count of real frames (the mask is prefix-contiguous,
        rawvideo_util.py:291-371 semantics)."""
        expect = _slot_shape(self.meta)
        if frames.shape != expect or frames.dtype != np.uint8:
            raise ValueError(
                f"packed clip must be uint8 {expect}, got "
                f"{frames.dtype} {frames.shape}")
        if key in self.clips:
            raise ValueError(f"duplicate packed clip key {key!r}")
        fh = self._shard_file()
        fh.write(np.ascontiguousarray(frames).tobytes())
        shard = len(self.shards) - 1
        slot = self.shards[-1]["count"]
        self.shards[-1]["count"] = slot + 1
        self.clips[key] = (shard, slot, int(n_valid))

    def close(self) -> str:
        """Flush shards and atomically publish index.json; returns its path."""
        if self._closed:
            return os.path.join(self.out_dir, INDEX_NAME)
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        index = {"version": FORMAT_VERSION, "meta": self.meta,
                 "shards": self.shards,
                 "clips": {k: list(v) for k, v in self.clips.items()}}
        path = os.path.join(self.out_dir, INDEX_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f)
        os.replace(tmp, path)       # readers see all-or-nothing
        self._closed = True
        return path


class PackedReader:
    """mmap-backed clip lookup.  Thread-safe; memmaps open lazily per shard
    and survive loader fork (worker_mode='process') — a memmap is just
    mapped pages, inherited for free."""

    def __init__(self, packed_dir: str):
        path = os.path.join(packed_dir, INDEX_NAME)
        with open(path) as f:
            index = json.load(f)
        if index.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"packed index {path}: version {index.get('version')!r} != "
                f"supported {FORMAT_VERSION}")
        self.packed_dir = packed_dir
        self.meta = index["meta"]
        self._shards_info = index["shards"]
        self.clips: Dict[str, Tuple[int, int, int]] = {
            k: tuple(v) for k, v in index["clips"].items()}
        self._maps: Dict[int, np.memmap] = {}
        self._lock = threading.Lock()
        self._slot = _slot_shape(self.meta)

    def check_compatible(self, max_frames: int, resolution: int,
                         video_framerate: int) -> None:
        want = {"max_frames": int(max_frames), "resolution": int(resolution),
                "video_framerate": int(video_framerate)}
        if self.meta != want:
            raise ValueError(
                f"packed corpus at {self.packed_dir} was sampled with "
                f"{self.meta}, dataset wants {want} — repack with "
                f"cli/pack_dataset.py")

    def __len__(self) -> int:
        return len(self.clips)

    def __contains__(self, key: str) -> bool:
        return key in self.clips

    def _map(self, shard: int) -> np.memmap:
        m = self._maps.get(shard)
        if m is None:
            with self._lock:
                m = self._maps.get(shard)
                if m is None:
                    info = self._shards_info[shard]
                    m = np.memmap(
                        os.path.join(self.packed_dir, info["file"]),
                        dtype=np.uint8, mode="r",
                        shape=(info["count"],) + self._slot)
                    self._maps[shard] = m
        return m

    def get(self, key: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(frames uint8 [F,R,R,3] COPY, mask float32 [F]) or None.
        Copied out of the map: callers get a private writable array (the
        dataset contract) and the one memcpy is the entire per-epoch read
        cost — the pages stay in the OS cache across epochs."""
        loc = self.clips.get(key)
        if loc is None:
            return None
        shard, slot, n_valid = loc
        frames = np.array(self._map(shard)[slot])      # one memcpy
        mask = np.zeros((self._slot[0],), np.float32)
        mask[:n_valid] = 1.0
        return frames, mask
