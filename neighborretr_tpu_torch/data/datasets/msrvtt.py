"""MSR-VTT annotation parsing (dataloader_msrvtt_retrieval.py:70-148).

train: MSRVTT_train.9k.csv (video_id column) + MSRVTT_data.json sentences —
       all captions of the 9k train videos.
val/test: MSRVTT_JSFUSION_test.csv (video_id, sentence) — the 1kA split, one
       caption per video, standard single-sentence eval.
"""

from __future__ import annotations

import csv
import json
import os
from collections import OrderedDict

from ..tokenizer import ClipTokenizer
from .base import RetrievalDataset


def build_msrvtt(subset: str, anno_path: str, video_path: str,
                 tokenizer: ClipTokenizer, **kw) -> RetrievalDataset:
    csv_name = ("MSRVTT_train.9k.csv" if subset == "train"
                else "MSRVTT_JSFUSION_test.csv")
    csv_file = os.path.join(anno_path, csv_name)
    with open(csv_file, newline="") as f:
        rows = list(csv.DictReader(f))

    pairs = []
    video_paths: "OrderedDict[str, str]" = OrderedDict()
    if subset == "train":
        train_ids = {r["video_id"] for r in rows}
        with open(os.path.join(anno_path, "MSRVTT_data.json")) as jf:
            data = json.load(jf)
        for item in data["sentences"]:
            vid = item["video_id"]
            if vid in train_ids:
                pairs.append((vid, item["caption"], None, None))
                video_paths[vid] = os.path.join(video_path, f"{vid}.mp4")
    else:
        for r in rows:
            vid = r["video_id"]
            pairs.append((vid, r["sentence"], None, None))
            video_paths[vid] = os.path.join(video_path, f"{vid}.mp4")

    return RetrievalDataset(pairs, video_paths, tokenizer,
                            multi_sentence_per_video=False, **kw)
