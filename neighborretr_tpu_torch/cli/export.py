"""Export a deployment bundle, on the port (↔ cli/export.py): the query
program traced with `torch.export`, the weights and the index.

    python -m neighborretr_tpu_torch.cli.export --index index.npz \
        --checkpoint best.npz --output bundle/ --query_batch 8 --topk 5 \
        [--device cuda|cpu]

The bundle (neighborretr_tpu_torch/deploy.py) runs with torch and numpy
alone, on the device it was exported for; it runs the plain versions, no
hand kernel.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Export a deployment bundle")
    p.add_argument("--index", required=True, help="index .npz (cli.index)")
    p.add_argument("--output", required=True, help="bundle directory to write")
    p.add_argument("--query_batch", type=int, default=8,
                   help="queries per call the program is traced for")
    p.add_argument("--topk", type=int, default=5)
    from .common import add_model_args
    add_model_args(p)
    args = p.parse_args(argv)

    from .. import deploy, serving
    from .common import load_query_model, resolve_device, setup_logger

    logger = setup_logger()
    device = resolve_device(args.device)
    index = serving.load_index(args.index)
    cfg, model = load_query_model(args, index, device, logger)
    out = deploy.save_bundle(args.output, model, cfg, index,
                             query_batch=args.query_batch, topk=args.topk)
    logger.info("Wrote bundle %s: %d videos, query_batch=%d, topk=%d, "
                "device %s", out, int(index["v_mask"].shape[0]),
                args.query_batch, args.topk, device.type)


if __name__ == "__main__":
    main()
