"""Training CLI of the port (↔ cli/train.py).

    python -m neighborretr_tpu_torch.cli.train --datatype msrvtt \\
        --anno_path ... --video_path ... --clip_checkpoint ViT-B-32.pt \\
        --output_dir outputs/msrvtt

The flags are the JAX CLI's, for everything the port supports, plus
`--device` (cuda by default; the plain versions run under `--device cpu`).
The towers start from an OpenAI CLIP checkpoint (`--clip_checkpoint`; left
out on a file-based dataset, the published one of `--base_encoder` is
fetched into the cache unless `--resume` supplies the weights), then
`--init_checkpoint` warm-starts from either package's npz or a
reference-trained `best.pth` (strict=False).  `--datatype synthetic`
trains on generated data: tiny towers unless `--clip_checkpoint random`
asks for the full-size model with seeded random weights.  `--packed_dir`
reads clips packed by `neighborretr_tpu_torch.cli.pack_dataset`.  A flag
for an option that is not ported exits with the reason.
Checkpoints (`best.npz`, `state_epochN.npz`, `state_preempt.npz`, and the
sharded preempt set of a multi-process run) are in the JAX package's npz
layout and resume in either package.

Data parallelism: `--num_devices N` runs N ranks on this host, one process
and one device each (this process is rank 0, the others are started with
the same arguments); `--coordinator host:port --num_processes N
--process_id I` starts one rank of a group launched by hand.  Each data
rank takes its block of every global batch; `--explicit_spmd` takes the
row-sharded loss form (parallel/spmd.py).  The model-sharded strategies
build the JAX CLI's meshes over the N ranks: `--tensor_parallel T` data ×
model (N/T, T), `--pipeline_parallel S [--pipeline_microbatches M]` data ×
stage (N/S, S), both data × stage × model (N/(S·T), S, T), and `--fsdp`
FSDP2 over the data ranks (parallel/mesh.py, tensor.py, pipeline.py), with
the JAX CLI's exits for the combinations it refuses.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import os

from ..core.config import (ClipConfig, Config, DataConfig, LossConfig,
                           ModelConfig, OptimizerConfig, TrainConfig, validate)
from .common import (add_attention_impl_arg, add_distributed_args,
                     init_distributed, ranks_on_this_host,
                     resolve_clip_checkpoint, resolve_device, tiny_requested)

# flags the JAX CLI has and the port does not honour yet: asking for one
# (a value other than the default shown) exits
UNPORTED = {
    "bank_placement": "device", "opt_moments_placement": "device",
    "debug_nans": False,
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
                   help="OpenAI CLIP .pt (TorchScript or state dict) to "
                        "start the towers from; 'random' = the full-size "
                        "model with seeded random weights; omitted on a "
                        "file-based dataset: the published weights of "
                        "--base_encoder, fetched once into the cache")
    p.add_argument("--tiny", action="store_true",
                   help="tiny towers for smoke runs (also implied by "
                        "--datatype synthetic without --clip_checkpoint)")
    p.add_argument("--init_checkpoint", default=None,
                   help="warm start after the CLIP weights (strict=False): "
                        "either package's npz, or a reference-trained "
                        "torch checkpoint (best.pth)")
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
    p.add_argument("--remat", action="store_true",
                   help="rematerialise the text and vision blocks in the "
                        "backward (memory for a second forward)")
    p.add_argument("--remat_policy", default="full",
                   choices=["full", "dots", "attn"],
                   help="what a rematerialised block keeps: its input "
                        "(full), also the attention sublayer's output "
                        "(attn), or that and the MLP's hidden and output "
                        "(dots)")
    p.add_argument("--remat_skip_last", type=int, default=0,
                   help="with --remat: the last N vision blocks save "
                        "everything")
    p.add_argument("--video_chunk_frames", type=int, default=0,
                   help="run the vision tower on N frames at a time, each "
                        "chunk rematerialised as a whole; 0 = off")
    add_attention_impl_arg(p)
    p.add_argument("--use_pallas", default="auto", choices=["auto", "on", "off"],
                   help="off: the similarity kernels' plain forms on any "
                        "device; auto/on: the kernels on a CUDA device")
    p.add_argument("--unroll_layers", action="store_true",
                   help="accepted for the JAX CLI's sake: the port's loop "
                        "over layers is always unrolled")
    add_distributed_args(p)
    p.add_argument("--explicit_spmd", action="store_true",
                   help="row-sharded losses on a data group of more than one "
                        "rank: each rank computes its rows of the similarity "
                        "matrices (parallel/spmd.py) instead of all of them "
                        "on the gathered features")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="split each block's matrices (Megatron layout) over "
                        "a `model` mesh axis of this size; the remaining "
                        "ranks form the data axis")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="split the towers depth-wise over a `stage` mesh "
                        "axis of this size (GPipe); the remaining ranks "
                        "form the data axis")
    p.add_argument("--pipeline_microbatches", type=int, default=0,
                   help="microbatches streamed through the pipeline per "
                        "step (0 → 4×stages)")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP2: shard every parameter and its moments over "
                        "the data ranks (gathered just in time for each "
                        "block, gradients reduce-scattered)")
    # the JAX CLI's flags for options that are not ported
    p.add_argument("--bank_placement", default="device",
                   choices=["device", "host"])
    p.add_argument("--opt_moments_placement", default="device",
                   choices=["device", "host"])
    p.add_argument("--debug_nans", action="store_true")
    return p.parse_args(argv)


def check_ported(args) -> None:
    asked = [f"--{k}" for k, default in UNPORTED.items()
             if getattr(args, k) != default]
    if asked:
        raise SystemExit(str(NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(asked))))


def build_config(args) -> Config:
    """Config from the flags; tiny towers (fp32) under --tiny, or when the
    data is synthetic and --clip_checkpoint was left out."""
    if tiny_requested(args):
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
    model = dc.replace(model, attention_impl=args.attention_impl,
                       remat=args.remat, remat_policy=args.remat_policy,
                       remat_skip_last=args.remat_skip_last,
                       video_chunk_frames=args.video_chunk_frames,
                       use_pallas=args.use_pallas,
                       unroll_layers=args.unroll_layers)
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
                          clip_checkpoint=(None if args.clip_checkpoint
                                           == "random"
                                           else args.clip_checkpoint),
                          resume_checkpoint=args.resume_checkpoint,
                          profile_dir=args.profile_dir,
                          micro_batches=args.micro_batches,
                          num_devices=args.num_devices,
                          explicit_spmd=args.explicit_spmd,
                          pipeline_parallel=args.pipeline_parallel,
                          pipeline_microbatches=args.pipeline_microbatches,
                          fsdp=args.fsdp,
                          mid_epoch_eval=bool(args.mid_epoch_eval)))


def mesh_layout(args, n: int):
    """(shape, axis names) of the training mesh over n ranks, with the JAX
    CLI's exits for what it refuses (cli/train.py:273-326)."""
    tp, pp = args.tensor_parallel, args.pipeline_parallel
    if args.fsdp and (tp > 1 or pp > 1):
        raise SystemExit("--fsdp applies to pure data-parallel meshes; drop "
                         "--tensor_parallel/--pipeline_parallel")
    if tp > 1 and pp > 1:
        if args.explicit_spmd:
            raise SystemExit("--tensor_parallel/--pipeline_parallel require "
                             "the GSPMD path (drop --explicit_spmd)")
        if n % (tp * pp):
            raise SystemExit(f"--tensor_parallel×--pipeline_parallel = "
                             f"{tp * pp} must divide the device count {n}")
        return (n // (tp * pp), pp, tp), ("data", "stage", "model")
    if tp > 1:
        if args.explicit_spmd:
            raise SystemExit("--tensor_parallel requires the GSPMD path "
                             "(drop --explicit_spmd)")
        if n % tp:
            raise SystemExit(f"--tensor_parallel {tp} must divide the "
                             f"device count {n}")
        return (n // tp, tp), ("data", "model")
    if pp > 1:
        if n % pp:
            raise SystemExit(f"--pipeline_parallel {pp} must divide the "
                             f"device count {n}")
        return (n // pp, pp), ("data", "stage")
    return (n,), ("data",)


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
    """Runs the training → (final TrainState, BestMetricsTracker); on a data
    group, this rank's."""
    args = parse_args(argv)
    check_ported(args)
    # a missing CLIP file fails before the output directory is written
    if args.clip_checkpoint not in (None, "random") and \
            not os.path.isfile(args.clip_checkpoint):
        raise SystemExit(f"--clip_checkpoint {args.clip_checkpoint}: no such "
                         "file")
    resolve_device(args.device)
    world = args.num_devices or args.num_processes or 1
    if args.num_devices and args.num_processes and \
            args.num_devices != args.num_processes:
        raise SystemExit(f"--num_devices {args.num_devices} does not cover "
                         f"the --num_processes {args.num_processes} ranks "
                         "(one device per rank)")
    shape, _ = mesh_layout(args, world)
    try:
        validate(build_config(args), shape[0])
    except ValueError as e:
        raise SystemExit(str(e))
    with ranks_on_this_host(args, "neighborretr_tpu_torch.cli.train", argv):
        started = init_distributed(args)
        try:
            return _run(args)
        finally:
            if started:
                import torch.distributed as dist
                dist.destroy_process_group()


def _run(args):
    from ..core.checkpoint import resolve_resume_auto
    from ..models.neighborretr import resolve_fused_attention
    from ..parallel.mesh import make_mesh
    from ..train.loop import run_training
    from ..utils.logging import setup_logger

    mesh = make_mesh(args.device, *mesh_layout(args, args.num_processes or 1))
    device = resolve_device(str(mesh.device))
    note = None
    if args.resume_checkpoint == "auto":
        args.resume_checkpoint = resolve_resume_auto(args.output_dir, mesh)
        note = "--resume auto: " + (
            f"resuming from {args.resume_checkpoint}"
            if args.resume_checkpoint
            else "no resumable state in output_dir, starting fresh")
    # a --resume state restores every weight, so it suppresses the fetch;
    # an --init_checkpoint does not (the reference's --init_model is a
    # partial load over CLIP-initialised towers, main.py:60-66)
    resolve_clip_checkpoint(
        args, weights_already_supplied=bool(args.resume_checkpoint))

    cfg = build_config(args)
    # an --attention_impl the configuration cannot serve fails here
    resolve_fused_attention(cfg.model, device)
    logger = setup_logger(output_dir=args.output_dir, is_main=mesh.rank == 0)
    if note:
        logger.info(note)
    logger.info("Device: %s", device)
    if mesh.collective:
        import torch.distributed as dist
        logger.info("Data group: %d rank(s) over %s, %s form", mesh.world,
                    dist.get_backend(), "explicit row-sharded"
                    if cfg.train.explicit_spmd and mesh.world > 1
                    else "gathered")
        logger.info("Mesh: %s%s", mesh.sizes,
                    ", FSDP2 over the data ranks" if cfg.train.fsdp else "")
    if args.pipeline_parallel > 1 and (args.unroll_layers
                                       or args.remat_skip_last):
        logger.warning(
            "--unroll_layers/--remat_skip_last shape the plain scan path; "
            "pipelined towers use their own per-microbatch schedule and "
            "ignore them (--remat and --remat_policy do carry over)")
    logger.info("Config:\n%s", cfg.to_json())
    train_ds, test_ds = build_datasets(args, cfg)
    return run_training(cfg, train_ds, test_ds, logger=logger, device=device,
                        mesh=mesh)


if __name__ == "__main__":
    main()
