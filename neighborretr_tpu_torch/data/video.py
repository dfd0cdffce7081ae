"""Video ingest: host-side decode to uint8 frames, device-side normalization.

TPU-first split of the reference's cv2+torchvision pipeline
(rawvideo_util.py:160-307):

  host:   cv2 seek/decode at `video_framerate` fps within [start, end] seconds
          (per-second index generation, rawvideo_util.py:172-200), bicubic
          resize of the short side to `resolution` + center crop — emitted as
          **uint8 RGB [F, R, R, 3]**, quartering host→device bandwidth vs fp32;
  device: `ops/video.py::normalize_frames` converts to float and applies the
          CLIP mean/std.

Uniform `linspace` down-sampling to max_frames replicates slice_framepos=2
(dataloader_msvd_retrieval.py:243-254).  Decode failures yield zero frames and
a zero mask, matching the reference's defensive fallback
(rawvideo_util.py:234-252).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

try:
    import cv2  # type: ignore
    _HAS_CV2 = True
except ImportError:  # pragma: no cover - cv2 is baked into the image
    _HAS_CV2 = False

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def generate_frame_indices(fps: int, total_frames: int, sample_fp: int,
                           start_sec: int, end_sec: int) -> List[int]:
    """Per-second sampling indices (rawvideo_util.py:172-200 behavior)."""
    if sample_fp <= 0:
        sample_fp = fps
    interval = max(1, fps // sample_fp)
    indices: List[int] = []
    for sec in range(start_sec, end_sec + 1):
        base = int(sec * fps)
        for off in list(range(0, fps, interval))[:sample_fp]:
            idx = base + off
            if idx < total_frames:
                indices.append(idx)
    return indices


def uniform_subsample(n_available: int, max_frames: int) -> np.ndarray:
    """slice_framepos=2: uniform linspace selection of frame positions."""
    if n_available <= max_frames:
        return np.arange(n_available)
    return np.linspace(0, n_available - 1, num=max_frames, dtype=int)


def resize_center_crop(frame_rgb: np.ndarray, resolution: int) -> np.ndarray:
    """Bicubic short-side resize + center crop → [R, R, 3] uint8."""
    h, w = frame_rgb.shape[:2]
    scale = resolution / min(h, w)
    nh, nw = max(resolution, int(round(h * scale))), max(resolution, int(round(w * scale)))
    resized = cv2.resize(frame_rgb, (nw, nh), interpolation=cv2.INTER_CUBIC)
    top = (nh - resolution) // 2
    left = (nw - resolution) // 2
    return resized[top: top + resolution, left: left + resolution]


def decode_video_frames(
    video_path: str,
    max_frames: int,
    resolution: int,
    video_framerate: int = 1,
    start_sec: Optional[float] = None,
    end_sec: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode → (frames uint8 [max_frames, R, R, 3], mask float32 [max_frames])."""
    frames = np.zeros((max_frames, resolution, resolution, 3), np.uint8)
    mask = np.zeros((max_frames,), np.float32)
    if not _HAS_CV2:
        return frames, mask

    try:
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            return frames, mask
        fps = int(round(cap.get(cv2.CAP_PROP_FPS))) or 1
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        duration = total / max(fps, 1)

        s = 0 if start_sec is None else max(0, int(start_sec))
        e = int(np.floor(duration)) if end_sec is None else int(min(end_sec, duration))
        e = max(e, s)

        indices = generate_frame_indices(fps, total, video_framerate, s, e)
        if not indices:
            indices = [0] if total > 0 else []
        sel = uniform_subsample(len(indices), max_frames)
        wanted = [indices[i] for i in sel]

        out = 0
        for fi in wanted:
            cap.set(cv2.CAP_PROP_POS_FRAMES, fi)
            ok, frame = cap.read()
            if not ok:
                continue
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames[out] = resize_center_crop(rgb, resolution)
            out += 1
        cap.release()
        mask[:out] = 1.0
    except Exception:   # defensive: zero frames on any decode error
        pass
    return frames, mask
