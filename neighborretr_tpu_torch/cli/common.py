"""Shared setup for the port's CLIs (↔ cli/common.py): the process group
(`init_distributed`, `--num_devices` on one host), device, config with the
--tiny switch, dataset, and weights.

Without --checkpoint the weights are seeded random (weights_io.init_model,
seed 0, so an index built that way verifies in a search that way); nothing
is downloaded.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses as dc
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from ..core.config import ClipConfig, Config, ModelConfig

RANDOM_WEIGHTS_SEED = 0


def add_distributed_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks on this host, one process and "
                        "one device each (cuda:0..N-1, or the CPU N times "
                        "under --device cpu), meeting over a local TCP "
                        "rendezvous; this process is rank 0")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: rendezvous address host:port of "
                        "rank 0 (launch the CLI once per process with the "
                        "same arguments)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-process: total process count")
    p.add_argument("--process_id", type=int, default=None,
                   help="multi-process: this process's rank")


def init_distributed(args) -> bool:
    """`torch.distributed.init_process_group` from --coordinator host:port
    --num_processes N --process_id I (↔ cli/common.py::init_distributed):
    NCCL under a CUDA --device, gloo on the CPU.  All three flags or none;
    returns whether a process group was started."""
    flags = (args.coordinator, args.num_processes, args.process_id)
    if all(v is None for v in flags):
        return False
    if any(v is None for v in flags):
        raise SystemExit("--coordinator, --num_processes and --process_id "
                         "must be given together")
    if not (0 <= args.process_id < args.num_processes):
        raise SystemExit(f"--process_id {args.process_id} out of range for "
                         f"--num_processes {args.num_processes}")
    import torch.distributed as dist

    from ..parallel.mesh import rank_device
    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device, args.process_id))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{args.coordinator}",
                            world_size=args.num_processes,
                            rank=args.process_id)
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _without_flag(argv, flag: str):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out


@contextlib.contextmanager
def ranks_on_this_host(args, module: str, argv):
    """`--num_devices N` without --coordinator: this process becomes rank 0
    of N, and ranks 1..N-1 run `python -m module` with the same arguments in
    child processes; all meet at a free localhost port (PyTorch's idiom for
    the JAX CLI's N-device mesh).  Sets the three rendezvous flags on
    `args`.  On leaving, the children are waited for (a failed child fails
    the command); if this process fails, they are killed."""
    n = args.num_devices
    if n is None or args.coordinator is not None:
        yield
        return
    from ..parallel.mesh import take_devices
    try:
        take_devices(n, torch.device(args.device).type)
    except ValueError as e:
        raise SystemExit(f"--num_devices {n}: {e}")
    addr = f"localhost:{_free_port()}"
    base = _without_flag(list(sys.argv[1:] if argv is None else argv),
                         "--num_devices")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    children = [subprocess.Popen(
        [sys.executable, "-m", module, *base, "--coordinator", addr,
         "--num_processes", str(n), "--process_id", str(r)], env=env)
        for r in range(1, n)]
    args.coordinator, args.num_processes, args.process_id = addr, n, 0
    try:
        yield
    except BaseException:
        for c in children:
            c.kill()
        for c in children:
            c.wait()
        raise
    failed = [(r, c.wait()) for r, c in enumerate(children, 1)]
    failed = [(r, rc) for r, rc in failed if rc != 0]
    if failed:
        raise SystemExit("ranks exited with errors: " + ", ".join(
            f"rank {r} → {rc}" for r, rc in failed))


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
