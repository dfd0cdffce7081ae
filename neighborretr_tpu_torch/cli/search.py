"""Free-text video search against a precomputed index, on the port
(↔ cli/search.py).

    python -m neighborretr_tpu_torch.cli.search --index index.npz --tiny \
        --device cpu --query "a man is cooking pasta"

Queries also stream from stdin (one per line) when no --query is given.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="Free-text video search")
    p.add_argument("--index", required=True, help="index .npz")
    p.add_argument("--query", action="append", default=None,
                   help="query text (repeatable); omit to read stdin lines")
    p.add_argument("--topk", type=int, default=5)
    from .common import add_model_args
    add_model_args(p)
    args = p.parse_args(argv)

    queries = args.query or [ln.strip() for ln in sys.stdin if ln.strip()]
    if not queries:
        raise SystemExit("no queries (pass --query or pipe lines on stdin)")

    from ..data.tokenizer import ClipTokenizer

    from .. import serving
    from .common import load_query_model, resolve_device, setup_logger

    logger = setup_logger()
    device = resolve_device(args.device)
    index = serving.load_index(args.index)
    cfg, model = load_query_model(args, index, device, logger)
    results = serving.search(model, cfg, index, ClipTokenizer(), queries,
                             topk=args.topk)
    for q, hits in zip(queries, results):
        print(f"query: {q}")
        for rank, (vid, score) in enumerate(hits, 1):
            print(f"  {rank}. {vid}  ({score:.4f})")


if __name__ == "__main__":
    main()
