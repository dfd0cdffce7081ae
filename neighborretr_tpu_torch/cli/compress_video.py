"""Offline video compression tool of the port (↔ cli/compress_video.py;
the reference's preprocess/compress_video.py).

Re-encodes a directory of videos to 3 fps with the short side scaled to 224 px
using ffmpeg, fanning the per-file jobs over a multiprocessing pool.  Files
that already exist at the destination with nonzero size are skipped.  The
port's loaders read the output as they read any clip.

    python -m neighborretr_tpu_torch.cli.compress_video --input_root raw/ \
        --output_root compressed/ [--fps 3] [--size 224] [--workers N]

Requires `ffmpeg` on PATH; exits with a clear message if absent.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import shutil
import subprocess
import sys

VIDEO_EXTS = {".mp4", ".avi", ".mkv", ".webm", ".mov", ".m4v", ".mpg", ".mpeg"}


def prepare_input_output_pairs(input_root: str, output_root: str):
    """Recursively enumerate (src, dst) pairs, mirroring directory layout."""
    pairs = []
    for dirpath, _, filenames in os.walk(input_root):
        rel = os.path.relpath(dirpath, input_root)
        for name in sorted(filenames):
            if os.path.splitext(name)[1].lower() not in VIDEO_EXTS:
                continue
            dst_dir = os.path.join(output_root, rel) if rel != "." else output_root
            pairs.append((os.path.join(dirpath, name),
                          os.path.join(dst_dir, name)))
    return pairs


def compress(job) -> str:
    """One ffmpeg re-encode: short side -> size px, fps capped (keeps AR).

    Encodes to a temp name and renames on success, so a failed or
    interrupted run never leaves a partial file that the skip-if-exists
    check would treat as complete."""
    src, dst, fps, size = job
    if os.path.exists(dst) and os.path.getsize(dst) > 0:
        return f"skip {dst}"
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tmp = dst + ".part" + os.path.splitext(dst)[1]
    scale = (f"scale='if(gt(iw,ih),-2,{size})':'if(gt(iw,ih),{size},-2)'")
    cmd = ["ffmpeg", "-y", "-i", src,
           "-filter:v", f"{scale},fps={fps}",
           "-map", "0:v", "-an",            # drop audio: retrieval never reads it
           "-loglevel", "error", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, dst)
        return f"ok   {dst}"
    except subprocess.CalledProcessError as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return f"FAIL {src}: {e.stderr.decode(errors='replace')[:200]}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ffmpeg re-encode for retrieval")
    p.add_argument("--input_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--fps", type=int, default=3)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--workers", type=int,
                   default=max(1, (os.cpu_count() or 2) // 2))
    args = p.parse_args(argv)

    if shutil.which("ffmpeg") is None:
        print("error: ffmpeg not found on PATH — install it or re-encode "
              "elsewhere; training only needs the compressed output.",
              file=sys.stderr)
        return 1

    pairs = prepare_input_output_pairs(args.input_root, args.output_root)
    if not pairs:
        print(f"no videos found under {args.input_root}", file=sys.stderr)
        return 1
    jobs = [(s, d, args.fps, args.size) for s, d in pairs]
    print(f"{len(jobs)} videos, {args.workers} workers")
    failures = 0
    with mp.Pool(args.workers) as pool:
        for i, msg in enumerate(pool.imap_unordered(compress, jobs), 1):
            print(f"[{i}/{len(jobs)}] {msg}")
            failures += msg.startswith("FAIL")
    if failures:
        print(f"{failures}/{len(jobs)} videos FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
