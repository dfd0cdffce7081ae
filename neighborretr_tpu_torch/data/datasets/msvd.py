"""MSVD annotation parsing (dataloader_msvd_retrieval.py:78-150).

{train,val,test}_list.txt + raw-captions.pkl (video_id → list of word lists);
all captions per video with cut_off_points for the multi-sentence eval
protocol.  Video files are discovered by walking the features directory.
"""

from __future__ import annotations

import os
import pickle

from ..tokenizer import ClipTokenizer
from .base import (RetrievalDataset, discover_video_paths,
                   warn_missing_videos)


def build_msvd(subset: str, anno_path: str, video_path: str,
               tokenizer: ClipTokenizer, **kw) -> RetrievalDataset:
    list_file = os.path.join(anno_path, f"{subset}_list.txt")
    with open(list_file) as fp:
        video_ids = [line.strip() for line in fp if line.strip()]

    with open(os.path.join(anno_path, "raw-captions.pkl"), "rb") as f:
        captions = pickle.load(f)

    video_paths = discover_video_paths(video_path, set(video_ids))
    # the multi-sentence protocol needs EVERY listed video (cut_off_points
    # index the full list), so ids without a file keep a synthesized path
    # and decode to zero frames (the msrvtt-style fallback) after a loud
    # build-time warning — not a mid-epoch KeyError
    warn_missing_videos("msvd", video_ids, video_paths, dropped=False)
    for vid in video_ids:
        video_paths.setdefault(vid, os.path.join(video_path, f"{vid}.avi"))

    pairs = []
    cut_off_points = []
    for vid in video_ids:
        for cap in captions[vid]:
            pairs.append((vid, " ".join(cap), None, None))
        cut_off_points.append(len(pairs))

    return RetrievalDataset(
        pairs, video_paths, tokenizer,
        multi_sentence_per_video=True,
        cut_off_points=cut_off_points,
        **kw)
