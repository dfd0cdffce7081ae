"""Shared setup for the port's index/search CLIs (↔ cli/common.py): device,
config with the --tiny switch, dataset, and weights.

Without --checkpoint the weights are seeded random (weights_io.init_model,
seed 0, so an index built that way verifies in a search that way); nothing
is downloaded.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import logging

import numpy as np
import torch

from ..core.config import ClipConfig, Config, ModelConfig

RANDOM_WEIGHTS_SEED = 0


def setup_logger() -> logging.Logger:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    return logging.getLogger("neighborretr_tpu_torch")


def add_attention_impl_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--attention_impl", default="auto",
                   choices=["auto", "einsum", "fused", "fused_block"],
                   help="the towers' attention: the whole sublayer in one "
                        "kernel (fused_block; sequences over 64 tokens take "
                        "fused), the attention kernel on packed qkv "
                        "(fused), plain PyTorch (einsum); auto = "
                        "fused_block on CUDA in bf16, else einsum")


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tiny", action="store_true",
                   help="tiny towers for smoke runs")
    p.add_argument("--base_encoder", default="ViT-B/32",
                   choices=list(ClipConfig.backbone_names()))
    p.add_argument("--checkpoint", default=None,
                   help="the JAX package's best.npz / state_epochN.npz")
    p.add_argument("--max_words", type=int, default=24)
    p.add_argument("--num_hidden_layers", type=int, default=4,
                   help="temporal transformer depth (must match the "
                        "checkpoint)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    add_attention_impl_arg(p)
    p.add_argument("--video_chunk_frames", type=int, default=0,
                   help="run the vision tower on N frames at a time; 0 = "
                        "off")


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is visible "
                         "(pass --device cpu to run the plain versions)")
    return dev


def model_config(args, max_frames: int, vocab_size: int = None) -> Config:
    """ModelConfig from the flags; --tiny shrinks the towers (fp32 compute,
    vocab_size when given, else the tiny default)."""
    if args.tiny:
        m = ModelConfig.tiny(max_words=args.max_words, max_frames=max_frames,
                             temporal_layers=args.num_hidden_layers)
        if vocab_size is not None:
            m = dc.replace(m, clip=dc.replace(m.clip, vocab_size=vocab_size))
    else:
        m = ModelConfig(clip=ClipConfig.from_name(args.base_encoder),
                        max_words=args.max_words, max_frames=max_frames,
                        temporal_layers=args.num_hidden_layers)
    m = dc.replace(m, attention_impl=args.attention_impl,
                   video_chunk_frames=args.video_chunk_frames)
    return Config(model=m)


def build_dataset(args, cfg: Config):
    """Synthetic smoke data or a real dataset split."""
    m = cfg.model
    if args.datatype == "synthetic":
        from ..data.datasets.synthetic import SyntheticDataset
        return SyntheticDataset(
            n=args.synthetic_size or max(32, args.batch_size), seed=2,
            max_words=m.max_words, max_frames=m.max_frames,
            resolution=m.clip.image_resolution, vocab_size=m.clip.vocab_size)
    from ..data.registry import EVAL_SUBSET, build_dataset
    from ..data.tokenizer import ClipTokenizer
    if args.subset is None and args.datatype not in EVAL_SUBSET:
        raise SystemExit(f"unknown datatype '{args.datatype}'; available: "
                         f"{sorted(EVAL_SUBSET)} (or 'synthetic')")
    return build_dataset(args.datatype, args.subset or EVAL_SUBSET[args.datatype],
                         args.anno_path, args.video_path, ClipTokenizer(),
                         max_words=m.max_words, max_frames=m.max_frames,
                         resolution=m.clip.image_resolution,
                         video_framerate=args.video_framerate)


def load_model(args, cfg: Config, device: torch.device, logger):
    from ..models import weights_io
    from ..models.neighborretr import resolve_fused_attention
    # an --attention_impl the configuration cannot serve fails here
    resolve_fused_attention(cfg.model, device)
    if args.checkpoint:
        model = weights_io.load_checkpoint(args.checkpoint, cfg.model, device)
        logger.info("Loaded checkpoint %s", args.checkpoint)
    else:
        model = weights_io.init_model(cfg.model, RANDOM_WEIGHTS_SEED, device)
        logger.info("No --checkpoint: using seeded random weights (seed %d)",
                    RANDOM_WEIGHTS_SEED)
    return model


def checkpoint_vocab(path: str) -> int:
    """Token-table size of a JAX package checkpoint (both npz layouts)."""
    with np.load(path, allow_pickle=False) as ckpt:
        for key in ("clip//text//token_embedding",
                    "params//clip//text//token_embedding"):
            if key in ckpt.files:
                return int(ckpt[key].shape[0])
    raise SystemExit(f"{path}: no clip//text//token_embedding entry")


def load_query_model(args, index, device: torch.device, logger):
    """Config + model for search: geometry from the flags and the index's
    frame count; the index meta is checked before the weights are built.
    Free-text queries tokenize with the full BPE, so a --tiny model takes
    the checkpoint's vocabulary, or the full one."""
    from .. import serving
    vocab = None
    if args.tiny:
        vocab = (checkpoint_vocab(args.checkpoint) if args.checkpoint
                 else ClipConfig().vocab_size)
    cfg = model_config(args, index["v_mask"].shape[1], vocab)
    serving.check_meta(index, cfg)
    return cfg, load_model(args, cfg, device, logger)
