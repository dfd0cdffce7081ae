"""ActivityNet Captions annotation parsing
(dataloader_activitynet_retrieval.py:156-250).

{train,val_1}.json keyed by pseudo id ("v_" + video_id) with duration +
sentences; ids from train_ids.json / val_ids.json.  All sentences of a video
join into one paragraph over span [0, ceil(duration)]; one paragraph per
video → standard single-sentence eval.
"""

from __future__ import annotations

import json
import math
import os

from ..tokenizer import ClipTokenizer
from .base import (RetrievalDataset, discover_video_paths,
                   warn_missing_videos)


def build_activitynet(subset: str, anno_path: str, video_path: str,
                      tokenizer: ClipTokenizer, **kw) -> RetrievalDataset:
    if subset == "train":
        ids_file, data_file = "train_ids.json", "train.json"
    else:
        ids_file, data_file = "val_ids.json", "val_1.json"

    with open(os.path.join(anno_path, ids_file)) as f:
        pseudo_ids = json.load(f)

    with open(os.path.join(anno_path, data_file)) as f:
        data = json.load(f)

    annotated = [pid for pid in pseudo_ids if pid in data]
    # files may be named with or without the "v_" prefix
    id_set = set(annotated) | {pid[2:] for pid in annotated}
    video_paths = discover_video_paths(video_path, id_set)

    pairs = []
    matched = set()
    for pid in annotated:
        v = data[pid]
        vid = pid[2:]  # strip "v_"
        path_key = vid if vid in video_paths else (pid if pid in video_paths else None)
        if path_key is None:
            continue
        matched.add(pid)
        end = int(math.ceil(float(v["duration"])))
        pairs.append((path_key, " ".join(v["sentences"]), 0.0, float(end)))

    warn_missing_videos("activitynet", annotated,
                        {pid: pid for pid in matched}, dropped=True)

    return RetrievalDataset(pairs, video_paths, tokenizer,
                            multi_sentence_per_video=False, **kw)
