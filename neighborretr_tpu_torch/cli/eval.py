"""Evaluation CLI of the port (↔ cli/eval.py): load a checkpoint of either
package, run the retrieval evaluation on a dataset split, print R@K.

    python -m neighborretr_tpu_torch.cli.eval --datatype msrvtt \\
        --anno_path ... --video_path ... --checkpoint outputs/msrvtt/best.npz

`--datatype synthetic --tiny` evaluates generated smoke data; without
`--checkpoint` the weights are seeded random.  `--num_devices N` encodes
over N data-parallel ranks on this host (one process and one device each;
`--coordinator/--num_processes/--process_id` start one rank by hand): each
rank encodes its block of every batch and every rank computes the R@K of
the gathered features.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Runs the evaluation → (t2v metrics, v2t metrics)."""
    p = argparse.ArgumentParser(
        description="NeighborRetr evaluation (PyTorch/CUDA port)")
    p.add_argument("--datatype", default="msrvtt",
                   help="msrvtt/msvd/didemo/activitynet, or synthetic")
    p.add_argument("--anno_path", default="")
    p.add_argument("--video_path", default="")
    p.add_argument("--subset", default=None)
    p.add_argument("--batch_size_val", type=int, default=128)
    p.add_argument("--synthetic_size", type=int, default=None,
                   help="--datatype synthetic: eval set size (default "
                        "max(32, batch_size_val))")
    p.add_argument("--max_frames", type=int, default=12)
    p.add_argument("--video_framerate", type=int, default=1)
    p.add_argument("--packed_dir", default="",
                   help="read clips packed by cli.pack_dataset (decode "
                        "the videos when empty)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--worker_mode", choices=["thread", "process"],
                   default="thread")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="the JAX CLI's sharded tower weights: not ported")
    from .common import add_distributed_args, add_model_args
    add_model_args(p)
    add_distributed_args(p)
    args = p.parse_args(argv)
    args.batch_size = args.batch_size_val       # build_dataset's default size
    if args.tensor_parallel != 1:
        raise SystemExit(str(NotImplementedError(
            "not ported to PyTorch yet: --tensor_parallel")))

    from .common import (init_distributed, ranks_on_this_host, resolve_device,
                         setup_logger)

    logger = setup_logger()
    resolve_device(args.device)
    world = args.num_processes or args.num_devices or 1
    if args.batch_size_val % world:
        if args.coordinator is not None:
            raise SystemExit(f"--batch_size_val {args.batch_size_val} must "
                             f"be divisible by the {world} ranks")
        logger.warning("batch_size_val %d not divisible by %d devices; "
                       "running single-device eval", args.batch_size_val,
                       world)
        args.num_devices = None
    with ranks_on_this_host(args, "neighborretr_tpu_torch.cli.eval", argv):
        started = init_distributed(args)
        try:
            return _run(args, logger)
        finally:
            if started:
                import torch.distributed as dist
                dist.destroy_process_group()


def _run(args, logger):
    from ..core.config import ClipConfig
    from ..data.loader import BatchLoader
    from ..parallel.mesh import make_mesh
    from ..train.evaluate import evaluate
    from .common import build_dataset, load_model, model_config, resolve_device

    mesh = make_mesh(args.device)
    device = resolve_device(str(mesh.device))
    if mesh.rank:
        logger.setLevel("ERROR")           # one rank logs
    # a tiny model on real data keeps the full BPE vocabulary
    vocab = None if args.datatype == "synthetic" else ClipConfig().vocab_size
    cfg = model_config(args, args.max_frames, vocab)
    ds = build_dataset(args, cfg)
    loader = BatchLoader(ds, args.batch_size_val, shuffle=False,
                         drop_last=False, workers=args.workers,
                         worker_mode=args.worker_mode, pad_to_batch=True,
                         process_index=mesh.rank, process_count=mesh.world)
    model = load_model(args, cfg, device, logger)
    return evaluate(model, cfg, loader, dataset=ds, logger=logger,
                    mesh=mesh)


if __name__ == "__main__":
    main()
