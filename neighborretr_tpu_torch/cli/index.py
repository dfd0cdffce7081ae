"""Build a video-feature retrieval index from a dataset split, on the port
(↔ cli/index.py).

    python -m neighborretr_tpu_torch.cli.index --datatype synthetic --tiny \
        --device cpu --out index.npz

The index file is the JAX package's layout; `neighborretr_tpu_torch.cli.
search` (or the JAX package's cli/search.py, with the same weights)
answers free-text queries against it.
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
    from .common import add_model_args
    add_model_args(p)
    args = p.parse_args(argv)

    from ..core.config import ClipConfig
    from ..data.loader import BatchLoader

    from .. import serving
    from .common import (build_dataset, load_model, model_config,
                         resolve_device, setup_logger)

    logger = setup_logger()
    device = resolve_device(args.device)
    # a tiny model on real data keeps the full BPE vocabulary
    vocab = (None if args.datatype == "synthetic"
             else ClipConfig().vocab_size)
    cfg = model_config(args, args.max_frames, vocab)
    ds = build_dataset(args, cfg)
    loader = BatchLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                         workers=args.workers, pad_to_batch=True)
    model = load_model(args, cfg, device, logger)
    index = serving.build_video_index(model, cfg, loader, dataset=ds,
                                      logger=logger,
                                      feature_dtype=args.feature_dtype)
    written = serving.save_index(args.out, index)
    logger.info("Wrote %s: %d videos, %.1f MB", written,
                len(index["video_ids"]), os.path.getsize(written) / 1e6)


if __name__ == "__main__":
    main()
