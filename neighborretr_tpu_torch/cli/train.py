"""Training CLI of the port (↔ cli/train.py).

    python -m neighborretr_tpu_torch.cli.train --datatype msrvtt \\
        --anno_path ... --video_path ... --init_checkpoint clip.npz \\
        --output_dir outputs/msrvtt

The flags are the JAX CLI's, for everything the port supports, plus
`--device` (cuda by default; the plain versions run under `--device cpu`).
`--datatype synthetic` trains on generated data: tiny towers unless
`--clip_checkpoint random` asks for the full-size model with seeded random
weights.  A flag for an option that is not ported exits with the reason.
Checkpoints (`best.npz`, `state_epochN.npz`, `state_preempt.npz`) are in the
JAX package's npz layout and resume in either package.
"""

from __future__ import annotations

import argparse
import dataclasses as dc

from ..core.config import (ClipConfig, Config, DataConfig, LossConfig,
                           ModelConfig, OptimizerConfig, TrainConfig, validate)
from .common import resolve_device

# flags the JAX CLI has and the port does not honour yet: asking for one
# (a value other than the default shown) exits
UNPORTED = {
    "num_devices": None, "remat": False, "remat_policy": "full",
    "attention_impl": "auto", "use_pallas": "auto", "unroll_layers": False,
    "explicit_spmd": False, "bank_placement": "device",
    "opt_moments_placement": "device", "tensor_parallel": 1,
    "pipeline_parallel": 1, "pipeline_microbatches": 0, "fsdp": False,
    "coordinator": None, "num_processes": None, "process_id": None,
    "video_chunk_frames": 0, "remat_skip_last": 0, "debug_nans": False,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="NeighborRetr training (PyTorch/CUDA port)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--datatype", default="synthetic")
    p.add_argument("--anno_path", default="")
    p.add_argument("--video_path", default="")
    p.add_argument("--output_dir", default="outputs/run")
    p.add_argument("--base_encoder", default="ViT-B/32",
                   choices=list(ClipConfig.backbone_names()))
    p.add_argument("--clip_checkpoint", default=None,
                   help="'random' = the full-size model with seeded random "
                        "weights; loading an OpenAI .pt is not ported (start "
                        "from an --init_checkpoint npz instead)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny towers for smoke runs (also implied by "
                        "--datatype synthetic without --clip_checkpoint)")
    p.add_argument("--init_checkpoint", default=None,
                   help="npz of either package to warm-start from "
                        "(strict=False)")
    p.add_argument("--resume", "--resume_checkpoint", default=None,
                   dest="resume_checkpoint",
                   help="state_epochN.npz / state_preempt.npz to resume from, "
                        "or 'auto' for the newest resumable state in "
                        "--output_dir (fresh start if none)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--batch_size_val", type=int, default=128)
    p.add_argument("--max_words", type=int, default=24)
    p.add_argument("--max_frames", type=int, default=12)
    p.add_argument("--video_framerate", type=int, default=1)
    p.add_argument("--num_hidden_layers", type=int, default=4,
                   help="temporal transformer depth")
    p.add_argument("--mb_batch", type=int, default=15)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--coef_lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.2)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--centrality_scale", type=float, default=0.3)
    p.add_argument("--kl_weight", type=float, default=1.0)
    p.add_argument("--uniform_weight", type=float, default=1.0)
    p.add_argument("--neighbor_weight", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=0.7)
    p.add_argument("--num_neighbors", type=int, default=20)
    p.add_argument("--temperature", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--worker_mode", choices=["thread", "process"],
                   default="thread")
    p.add_argument("--n_display", type=int, default=50)
    p.add_argument("--mid_epoch_eval", type=int, default=1, choices=[0, 1],
                   help="validate every n_display*3 steps mid-epoch; 0 = "
                        "per-epoch eval only")
    p.add_argument("--bank_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--opt_moments_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--micro_batches", type=int, default=1,
                   help="encode the batch in N sequential micro-batches while "
                        "the losses see the full batch: exact gradients, ~N× "
                        "lower peak activation memory, one extra forward")
    p.add_argument("--synthetic_size", type=int, default=256)
    p.add_argument("--augment", default="rand-m7-n4-mstd0.5-inc1",
                   help="train-time video RandAugment policy; '' disables")
    p.add_argument("--augment_backend", default="auto",
                   choices=["auto", "native", "pil", "device"])
    p.add_argument("--frame_order", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--video_cache_size", type=int, default=0)
    p.add_argument("--packed_dir", default="")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of early steps here")
    # the JAX CLI's flags for options that are not ported
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat_policy", default="full",
                   choices=["full", "dots", "attn"])
    p.add_argument("--attention_impl", default="auto",
                   choices=["auto", "einsum", "fused", "fused_block"])
    p.add_argument("--use_pallas", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--unroll_layers", action="store_true")
    p.add_argument("--explicit_spmd", action="store_true")
    p.add_argument("--bank_placement", default="device",
                   choices=["device", "host"])
    p.add_argument("--opt_moments_placement", default="device",
                   choices=["device", "host"])
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--pipeline_parallel", type=int, default=1)
    p.add_argument("--pipeline_microbatches", type=int, default=0)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--video_chunk_frames", type=int, default=0)
    p.add_argument("--remat_skip_last", type=int, default=0)
    p.add_argument("--debug_nans", action="store_true")
    return p.parse_args(argv)


def check_ported(args) -> None:
    asked = [f"--{k}" for k, default in UNPORTED.items()
             if getattr(args, k) != default]
    if args.augment_backend == "device":
        asked.append("--augment_backend device")
    if args.clip_checkpoint not in (None, "random"):
        asked.append("--clip_checkpoint <file>")
    if asked:
        raise SystemExit(str(NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(asked))))


def build_config(args) -> Config:
    """Config from the flags; tiny towers (fp32) under --tiny, or when the
    data is synthetic and --clip_checkpoint was left out."""
    tiny = args.tiny or (args.datatype == "synthetic"
                         and args.clip_checkpoint is None)
    if tiny:
        model = ModelConfig.tiny(max_words=args.max_words,
                                 max_frames=args.max_frames,
                                 temporal_layers=args.num_hidden_layers)
        if args.datatype != "synthetic":
            # real datasets tokenize with the full BPE; the tiny table
            # would clamp their ids
            model = dc.replace(model, clip=dc.replace(
                model.clip, vocab_size=ClipConfig().vocab_size))
    else:
        model = ModelConfig(clip=ClipConfig.from_name(args.base_encoder),
                            max_words=args.max_words,
                            max_frames=args.max_frames,
                            temporal_layers=args.num_hidden_layers)
    return Config(
        model=model,
        loss=LossConfig(centrality_scale=args.centrality_scale,
                        kl_weight=args.kl_weight,
                        uniform_weight=args.uniform_weight,
                        neighbor_weight=args.neighbor_weight, beta=args.beta,
                        num_neighbors=args.num_neighbors,
                        temperature=args.temperature),
        optim=OptimizerConfig(lr=args.lr, coef_lr=args.coef_lr,
                              weight_decay=args.weight_decay,
                              warmup_proportion=args.warmup_proportion,
                              moments_dtype=args.opt_moments_dtype),
        data=DataConfig(datatype=args.datatype, data_path=args.anno_path,
                        video_path=args.video_path, max_words=args.max_words,
                        max_frames=args.max_frames,
                        video_framerate=args.video_framerate,
                        workers=args.workers, worker_mode=args.worker_mode,
                        augment=args.augment or "",
                        augment_backend=args.augment_backend,
                        packed_dir=args.packed_dir),
        train=TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                          batch_size_val=args.batch_size_val,
                          mb_batch=args.mb_batch, seed=args.seed,
                          bank_dtype=args.bank_dtype,
                          n_display=args.n_display,
                          output_dir=args.output_dir,
                          init_checkpoint=args.init_checkpoint,
                          resume_checkpoint=args.resume_checkpoint,
                          profile_dir=args.profile_dir,
                          micro_batches=args.micro_batches,
                          mid_epoch_eval=bool(args.mid_epoch_eval)))


def build_datasets(args, cfg: Config):
    clip = cfg.model.clip
    if args.datatype == "synthetic":
        from ..data.datasets.synthetic import SyntheticDataset
        kw = dict(max_words=args.max_words, max_frames=args.max_frames,
                  resolution=clip.image_resolution, vocab_size=clip.vocab_size)
        return (SyntheticDataset(n=args.synthetic_size, seed=1, **kw),
                SyntheticDataset(n=max(32, args.batch_size_val), seed=2, **kw))
    from ..data.registry import EVAL_SUBSET, build_dataset
    from ..data.tokenizer import ClipTokenizer
    if args.datatype not in EVAL_SUBSET:
        raise SystemExit(f"unknown datatype '{args.datatype}'; available: "
                         f"{sorted(EVAL_SUBSET)} (or 'synthetic')")
    tokenizer = ClipTokenizer()
    kw = dict(max_words=args.max_words, max_frames=args.max_frames,
              resolution=clip.image_resolution,
              video_framerate=args.video_framerate, packed_dir=args.packed_dir)
    train_ds = build_dataset(args.datatype, "train", args.anno_path,
                             args.video_path, tokenizer, is_train=True,
                             augment=args.augment or None,
                             augment_backend=args.augment_backend,
                             frame_order=args.frame_order,
                             cache_capacity=args.video_cache_size,
                             seed=args.seed, **kw)
    test_ds = build_dataset(args.datatype, EVAL_SUBSET[args.datatype],
                            args.anno_path, args.video_path, tokenizer, **kw)
    return train_ds, test_ds


def main(argv=None):
    """Runs the training → (final TrainState, BestMetricsTracker)."""
    args = parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)

    from ..core.checkpoint import latest_resumable
    from ..train.loop import run_training
    from ..utils.logging import setup_logger

    note = None
    if args.resume_checkpoint == "auto":
        args.resume_checkpoint = latest_resumable(args.output_dir)
        note = "--resume auto: " + (
            f"resuming from {args.resume_checkpoint}"
            if args.resume_checkpoint
            else "no resumable state in output_dir, starting fresh")
    if (args.clip_checkpoint is None and args.datatype != "synthetic"
            and not args.tiny and not args.init_checkpoint
            and not args.resume_checkpoint):
        raise SystemExit(str(NotImplementedError(
            "not ported to PyTorch yet: fetching the published CLIP weights; "
            "pass --init_checkpoint <npz>, or --clip_checkpoint random")))

    cfg = build_config(args)
    validate(cfg, 1)
    logger = setup_logger(output_dir=args.output_dir)
    if note:
        logger.info(note)
    logger.info("Device: %s", device)
    logger.info("Config:\n%s", cfg.to_json())
    train_ds, test_ds = build_datasets(args, cfg)
    return run_training(cfg, train_ds, test_ds, logger=logger, device=device)


if __name__ == "__main__":
    main()
