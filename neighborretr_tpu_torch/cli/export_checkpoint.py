"""Export a checkpoint to the reference's torch state-dict layout, on the
port (↔ cli/export_checkpoint.py).

    python -m neighborretr_tpu_torch.cli.export_checkpoint \
        --checkpoint best.npz --out pytorch_model.bin [--device cuda|cpu]

The input is either package's npz checkpoint (best.npz or state_epochN.npz);
the output loads into the reference's NeighborRetr through
load_state_dict(strict=False) / its --init_model.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export to the reference's (torch) checkpoint layout")
    p.add_argument("--out", required=True, help="output .bin/.pth path")
    p.add_argument("--max_frames", type=int, default=12)
    from .common import add_model_args
    add_model_args(p)
    args = p.parse_args(argv)
    if not args.checkpoint:
        p.error("--checkpoint is required: the npz checkpoint to export")

    from ..models import weights_io
    from .common import (checkpoint_vocab, load_model, model_config,
                         resolve_device, setup_logger)

    logger = setup_logger()
    device = resolve_device(args.device)
    # a --tiny checkpoint carries its own vocabulary size
    cfg = model_config(args, args.max_frames,
                       checkpoint_vocab(args.checkpoint) if args.tiny
                       else None)
    model = load_model(args, cfg, device, logger)
    weights_io.save_reference_checkpoint(model, args.out)
    print(f"Exported {args.checkpoint} -> {args.out} "
          f"(reference state-dict layout)")


if __name__ == "__main__":
    main()
