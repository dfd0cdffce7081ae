"""Cells cut to a size the CPU tests hold: the cell's own files with the
towers and the traffic made tiny, float32 compute (the program's plain
paths), so that a sound program agrees with the reference to rounding."""

import copy

from benchmark.harness import core

TINY_CLIP = {"embed_dim": 64, "image_resolution": 32, "vision_layers": 2,
             "vision_width": 128, "vision_patch_size": 16, "context_length": 77,
             "vocab_size": 49408, "transformer_width": 64,
             "transformer_heads": 1, "transformer_layers": 2}


def tiny_files(cell: str) -> dict:
    files = copy.deepcopy(core.cell_files(core.manifest(), cell))
    c, t = files["config"], files["traffic"]
    c["clip"] = dict(TINY_CLIP)
    c["model"].update(temporal_layers=2, compute_dtype="float32",
                      remat=False)
    c["reference_chunk"] = 4
    if t["driver"] == "train":
        t.update(batch=8, mb_batch=3, pool=4, max_words=12, max_frames=4,
                 caption_tokens=[3, 10], frames=[2, 4])
        t["loss"]["num_neighbors"] = 3
    else:
        t.update(videos=300, queries=40, clients=4, judge=6, judge_longest=2,
                 max_frames=4, frames=[2, 4], max_batch=16)
    return files
