"""DiDeMo annotation parsing (dataloader_didemo_retrieval.py:75-175).

{train,val,test}_list.txt + {train,val,test}_data.json.  All moment
descriptions of a video concatenate into one paragraph; the temporal span is
forced to [0, 31] seconds (videos were truncated to 30s during annotation).
One paragraph-caption per video → standard single-sentence eval protocol.
"""

from __future__ import annotations

import json
import os

from ..tokenizer import ClipTokenizer
from .base import (RetrievalDataset, discover_video_paths,
                   warn_missing_videos)


def build_didemo(subset: str, anno_path: str, video_path: str,
                 tokenizer: ClipTokenizer, **kw) -> RetrievalDataset:
    with open(os.path.join(anno_path, f"{subset}_list.txt")) as fp:
        video_ids = [line.strip() for line in fp if line.strip()]
    id_set = set(video_ids)

    with open(os.path.join(anno_path, f"{subset}_data.json")) as f:
        json_data = json.load(f)

    texts = {}
    for item in json_data:
        vid = item["video"]
        if vid not in id_set:
            continue
        texts.setdefault(vid, []).append(item["description"])

    # some DiDeMo ids keep their extension → keep_extension_ids
    video_paths = discover_video_paths(video_path, id_set,
                                       keep_extension_ids=True)
    warn_missing_videos("didemo", [v for v in video_ids if v in texts],
                        video_paths, dropped=True)

    pairs = []
    for vid in video_ids:
        if vid in texts and vid in video_paths:
            pairs.append((vid, " ".join(texts[vid]), 0.0, 31.0))
    if not pairs:
        raise ValueError(
            f"didemo/{subset}: no (caption, video) pairs survived — check "
            "--anno_path/--video_path (ids in the list file must appear in "
            "both the data json and the video directory)")

    return RetrievalDataset(pairs, video_paths, tokenizer,
                            multi_sentence_per_video=False, **kw)
