"""Dataset registry (the reference's DATALOADER_DICT, data_dataloaders.py:323).

Split conventions follow main.py:99-115: msrvtt/activitynet evaluate on the
'val' annotations, didemo/msvd on 'test'.
"""

from __future__ import annotations

from typing import Callable, Dict

from .datasets.activitynet import build_activitynet
from .datasets.didemo import build_didemo
from .datasets.msrvtt import build_msrvtt
from .datasets.msvd import build_msvd

DATASET_FACTORIES: Dict[str, Callable] = {
    "msrvtt": build_msrvtt,
    "msvd": build_msvd,
    "didemo": build_didemo,
    "activity": build_activitynet,
    "activitynet": build_activitynet,
}

EVAL_SUBSET: Dict[str, str] = {
    "msrvtt": "val",
    "msvd": "test",
    "didemo": "test",
    "activity": "val",
    "activitynet": "val",
}


def build_dataset(datatype: str, subset: str, anno_path: str, video_path: str,
                  tokenizer, **kw):
    if datatype not in DATASET_FACTORIES:
        raise KeyError(f"unknown datatype {datatype!r}; "
                       f"available: {sorted(DATASET_FACTORIES)}")
    return DATASET_FACTORIES[datatype](subset, anno_path, video_path, tokenizer, **kw)
