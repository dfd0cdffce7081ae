"""Build a video-feature retrieval index from a dataset split, on the port
(↔ cli/index.py).

    python -m neighborretr_tpu_torch.cli.index --datatype synthetic --tiny \
        --device cpu --out index.npz

The index file is the JAX package's layout; `neighborretr_tpu_torch.cli.
search` or `.serve` (or the JAX package's CLIs, with the same weights)
answer free-text queries against it.  `--append` grows an existing index:
its videos are skipped, only the new ones are encoded, and the merge is
written back (a running `cli.serve` picks it up on POST /reload).
`--num_devices N` splits each encode batch over N devices of this process
(cuda:0..N-1, or the CPU N times under --device cpu).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Build a video retrieval index")
    p.add_argument("--datatype", default="msrvtt",
                   help="msrvtt/msvd/didemo/activitynet, or synthetic")
    p.add_argument("--anno_path", default="")
    p.add_argument("--video_path", default="")
    p.add_argument("--subset", default=None)
    p.add_argument("--video_framerate", type=int, default=1)
    p.add_argument("--max_frames", type=int, default=12)
    p.add_argument("--out", required=True, help="output index .npz path")
    p.add_argument("--feature_dtype", default="float16",
                   choices=["float16", "int8"])
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--synthetic_size", type=int, default=None,
                   help="--datatype synthetic: corpus size (default "
                        "max(32, batch_size))")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--worker_mode", choices=["thread", "process"],
                   default="thread",
                   help="loader workers: threads (default) or forked "
                        "processes (scales Python-level augment cost on "
                        "many-core hosts)")
    p.add_argument("--num_devices", type=int, default=1,
                   help="shard each encode batch over this many devices "
                        "(data-parallel corpus ViT forwards; batch_size "
                        "must divide). 1 = single device")
    p.add_argument("--append", action="store_true",
                   help="incremental build: if --out already exists, skip "
                        "its videos, encode only the new ones, and merge "
                        "(same checkpoint/config required)")
    from .common import add_model_args
    add_model_args(p)
    args = p.parse_args(argv)

    from ..core.config import ClipConfig
    from ..data.loader import BatchLoader

    from .. import serving
    from .common import (build_dataset, checkpoint_vocab, load_model,
                         model_config, resolve_device, setup_logger)

    logger = setup_logger()
    device = resolve_device(args.device)
    devices = None
    if args.num_devices > 1:
        if args.batch_size % args.num_devices:
            raise SystemExit(f"--batch_size {args.batch_size} must divide "
                             f"over --num_devices {args.num_devices}")
        from ..parallel.mesh import take_devices
        devices = take_devices(args.num_devices, device.type)
        device = devices[0]
        logger.info("Encoding data-parallel over %d devices",
                    args.num_devices)
    # a tiny model takes its checkpoint's vocabulary; without one, the
    # full BPE vocabulary on real data
    if args.tiny and args.checkpoint:
        vocab = checkpoint_vocab(args.checkpoint)
    else:
        vocab = (None if args.datatype == "synthetic"
                 else ClipConfig().vocab_size)
    cfg = model_config(args, args.max_frames, vocab)
    ds = build_dataset(args, cfg)
    loader = BatchLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                         workers=args.workers, worker_mode=args.worker_mode,
                         pad_to_batch=True)
    model = load_model(args, cfg, device, logger)

    existing = None
    out_path = serving.index_path(args.out)
    if args.append and os.path.exists(out_path):
        existing = serving.load_index(out_path)
        logger.info("Appending to %s: its %d indexed videos are skipped",
                    out_path, len(existing["video_ids"]))
        if ("v_scale" in existing) != (args.feature_dtype == "int8"):
            raise SystemExit(
                "--feature_dtype differs from the existing index "
                f"({'int8' if 'v_scale' in existing else 'float16'}); "
                "match it or rebuild without --append")
        # another checkpoint or config fails now, before any forward
        serving.check_meta(existing, cfg, model)

    skip = ({str(v) for v in existing["video_ids"]}
            if existing is not None else None)
    try:
        index = serving.build_video_index(model, cfg, loader, dataset=ds,
                                          logger=logger,
                                          feature_dtype=args.feature_dtype,
                                          skip_ids=skip, devices=devices)
    except ValueError as e:
        if existing is not None and "no valid videos" in str(e):
            logger.info("No new videos to index; %s unchanged", out_path)
            return
        raise
    if existing is not None:
        before = len(existing["video_ids"])
        index = serving.append_index(existing, index)
        logger.info("Appended %d new videos",
                    len(index["video_ids"]) - before)
    written = serving.save_index(args.out, index)
    logger.info("Wrote %s: %d videos, %.1f MB", written,
                len(index["video_ids"]), os.path.getsize(written) / 1e6)

if __name__ == "__main__":
    main()
