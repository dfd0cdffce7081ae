"""Offline corpus packer: decode every clip once into mmap-able shards
(↔ cli/pack_dataset.py, on the port's own data/ package; the packs are the
same files, so either package's --packed_dir reads them).

The train-time host cost of the input path (and the reference's — its
DataLoader workers re-decode every epoch, data_dataloaders.py:36-47,
rawvideo_util.py:249-283) is dominated by cv2 seek+decode.  This tool runs
that decode ONCE — same sampler semantics as training
(per-second indices → linspace subsample → bicubic resize + center crop,
data/video.py) — and stores the uint8 [F, R, R, 3] clips in the packed
format of data/packed.py.  Training then reads clips as page-cached
memcpys via `--packed_dir`; RandAugment still re-samples per epoch on the
loaded frames.

    python -m neighborretr_tpu_torch.cli.pack_dataset --datatype msrvtt \
        --anno_path anns/ --video_path videos/ --output_dir packed/ \
        [--subsets train,val,test] [--max_frames 12] [--resolution 224] \
        [--video_framerate 1] [--workers N] [--clips_per_shard 256]

Clips are keyed by (video_id, start, end) so paragraph datasets
(DiDeMo/ActivityNet) pack one clip per caption window.  Prints one JSON
summary line: clips, bytes, decode ms/clip (the cost the packing amortizes).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datatype", required=True,
                   help="msrvtt | msvd | didemo | activity")
    p.add_argument("--anno_path", required=True)
    p.add_argument("--video_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--subsets", default="train,val,test",
                   help="comma-separated; unknown subsets for a datatype "
                        "are skipped (msrvtt has no separate val tree)")
    p.add_argument("--max_frames", type=int, default=12)
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--video_framerate", type=int, default=1)
    p.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    p.add_argument("--clips_per_shard", type=int, default=256)
    return p.parse_args(argv)


def collect_clip_jobs(args):
    """Unique (key, path, start, end) across the requested subsets."""
    from ..data.packed import clip_key
    from ..data.registry import build_dataset
    from ..data.tokenizer import ClipTokenizer

    tokenizer = ClipTokenizer()
    jobs = {}
    for subset in [s for s in args.subsets.split(",") if s]:
        try:
            ds = build_dataset(args.datatype, subset, args.anno_path,
                               args.video_path, tokenizer,
                               max_frames=args.max_frames,
                               resolution=args.resolution,
                               video_framerate=args.video_framerate)
        except (FileNotFoundError, KeyError) as e:
            print(f"# subset {subset!r}: skipped ({e})", file=sys.stderr)
            continue
        for video_id, _, start, end in ds.pairs:
            key = clip_key(video_id, start, end)
            if key not in jobs and video_id in ds.video_paths:
                jobs[key] = (ds.video_paths[video_id], start, end)
    return jobs


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..data.packed import PackedWriter
    from ..data.video import decode_video_frames

    jobs = collect_clip_jobs(args)
    if not jobs:
        print("no clips found — check --datatype/--anno_path/--video_path",
              file=sys.stderr)
        return 1

    writer = PackedWriter(args.output_dir, args.max_frames, args.resolution,
                          args.video_framerate,
                          clips_per_shard=args.clips_per_shard)

    def decode(item):
        key, (path, start, end) = item
        frames, mask = decode_video_frames(
            path, args.max_frames, args.resolution, args.video_framerate,
            start, end)
        return key, frames, int(mask.sum())

    tic = time.perf_counter()
    n_empty = 0
    # parallel decode (cv2 releases the GIL), single-threaded ordered write —
    # the index order, and therefore the artifact, is deterministic
    items = sorted(jobs.items())
    with cf.ThreadPoolExecutor(max(1, args.workers)) as pool:
        for key, frames, n_valid in pool.map(decode, items):
            if n_valid == 0:
                n_empty += 1    # decode failure → packed as all-zero, the
                # dataset's zero-fallback semantics (rawvideo_util.py:234-252)
            writer.add(key, frames, n_valid)
    index_path = writer.close()
    elapsed = time.perf_counter() - tic

    total_bytes = sum(
        os.path.getsize(os.path.join(args.output_dir, s["file"]))
        for s in writer.shards)
    print(json.dumps({
        "packed_clips": len(jobs),
        "empty_clips": n_empty,
        "bytes": total_bytes,
        "decode_wall_s": round(elapsed, 2),
        "decode_ms_per_clip_wall": round(1000 * elapsed / len(jobs), 2),
        "workers": args.workers,
        "index": index_path,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
