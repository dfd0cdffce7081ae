"""The program under test, set up from a cell's files: its configuration,
its model with the benchmark's weights.  The only module of the harness
that imports the program."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from . import core, weights


def reference_cfg(files: dict) -> dict:
    """The plain dict of sizes and settings the reference and the counts
    take, from the cell's configuration and traffic files."""
    c, t = files["config"], files["traffic"]
    model = dict(c["clip"], **c["model"])
    model["max_words"] = t["max_words"]
    model["max_frames"] = t["max_frames"]
    return {"model": model, "loss": t.get("loss", {}),
            "optim": t.get("optim", {}),
            "train": {"mb_batch": t.get("mb_batch", 0)}}


def program_clip(clip: dict):
    """The program's `ClipConfig` for a configuration file's `clip` block.
    A key that is a dataclass field of `ClipConfig` is passed to it; a key
    the program has only as a derived attribute (a property, such as
    `vision_heads`) must equal that attribute; a key it does not know at all
    raises.  So a configuration the program cannot express fails its run by
    name instead of running as a different model."""
    from neighborretr_tpu_torch.core.config import ClipConfig
    fields = {f.name for f in dataclasses.fields(ClipConfig)}
    out = ClipConfig(**{k: v for k, v in clip.items() if k in fields})
    for k, v in clip.items():
        if k in fields:
            continue
        if not isinstance(getattr(ClipConfig, k, None), property):
            raise core.BenchError(f"clip key {k!r} = {v!r}: the program's "
                                  "ClipConfig has no such setting")
        if getattr(out, k) != v:
            raise core.BenchError(f"clip key {k!r} = {v!r}, but the program's "
                                  f"ClipConfig derives {k} = "
                                  f"{getattr(out, k)!r}")
    return out


def program_config(files: dict):
    """The program's Config for the cell (its `clip` block by
    `program_clip`)."""
    from neighborretr_tpu_torch.core import config as C
    c, t = files["config"], files["traffic"]
    clip = program_clip(c["clip"])
    m = dict(c["model"])
    for k in ("text_merge_ratios", "video_merge_ratios"):
        m[k] = tuple(m[k])
    model = C.ModelConfig(clip=clip, max_words=t["max_words"],
                          max_frames=t["max_frames"], **m)
    cfg = C.Config()
    repl = {"model": model,
            "data": dataclasses.replace(cfg.data, max_words=t["max_words"],
                                        max_frames=t["max_frames"],
                                        train_augment=False)}
    if "batch" in t:
        repl["train"] = dataclasses.replace(
            cfg.train, batch_size=t["batch"], mb_batch=t["mb_batch"],
            micro_batches=t.get("micro_batches", 1))
    if "optim" in t:
        o = {k: v for k, v in t["optim"].items() if k != "t_total"}
        repl["optim"] = dataclasses.replace(cfg.optim, **o)
    if "loss" in t:
        repl["loss"] = dataclasses.replace(cfg.loss, **t["loss"])
    return dataclasses.replace(cfg, **repl)


def shapes(model) -> list:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def build_model(cfg, seed: int, device):
    """The program's model on `device` with the benchmark's weights from
    `seed`."""
    from neighborretr_tpu_torch.models.neighborretr import NeighborRetr
    model = NeighborRetr(cfg.model, device=device)
    w = weights.make(shapes(model), core.derive(seed, "weights"), device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return model


def reference_weights(model_shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """The same weights again, for the reference."""
    return weights.make(model_shapes, core.derive(seed, "weights"), device)
