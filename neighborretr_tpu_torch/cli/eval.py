"""Evaluation CLI of the port (↔ cli/eval.py): load a checkpoint of either
package, run the retrieval evaluation on a dataset split, print R@K.

    python -m neighborretr_tpu_torch.cli.eval --datatype msrvtt \\
        --anno_path ... --video_path ... --checkpoint outputs/msrvtt/best.npz

`--datatype synthetic --tiny` evaluates generated smoke data; without
`--checkpoint` the weights are seeded random.  One device (`--device`).
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
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--worker_mode", choices=["thread", "process"],
                   default="thread")
    from .common import add_model_args
    add_model_args(p)
    args = p.parse_args(argv)
    args.batch_size = args.batch_size_val       # build_dataset's default size

    from ..core.config import ClipConfig
    from ..data.loader import BatchLoader
    from ..train.evaluate import evaluate
    from .common import (build_dataset, load_model, model_config,
                         resolve_device, setup_logger)

    logger = setup_logger()
    device = resolve_device(args.device)
    # a tiny model on real data keeps the full BPE vocabulary
    vocab = None if args.datatype == "synthetic" else ClipConfig().vocab_size
    cfg = model_config(args, args.max_frames, vocab)
    ds = build_dataset(args, cfg)
    loader = BatchLoader(ds, args.batch_size_val, shuffle=False,
                         drop_last=False, workers=args.workers,
                         worker_mode=args.worker_mode, pad_to_batch=True)
    model = load_model(args, cfg, device, logger)
    return evaluate(model, cfg, loader, dataset=ds, logger=logger)


if __name__ == "__main__":
    main()
