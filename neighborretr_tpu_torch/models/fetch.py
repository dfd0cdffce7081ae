"""Fetch-and-cache for the published OpenAI CLIP checkpoints (↔
neighborretr_tpu/models/fetch.py, the same zoo, cache directory and
variable, so one cached file serves both packages).

Reference counterpart: `module_clip.py:22-81` — a named backbone resolves
to a model-zoo URL whose penultimate path component is the file's sha256
(OpenAI's publication convention); the file lands in a local cache and is
digest-verified.  The digest is computed while the file streams in, and the
download writes to a temp file promoted by atomic rename, so an interrupted
fetch never leaves a corrupt cache entry for a later run to trust.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
from typing import Optional

# Published OpenAI CLIP model zoo (the reference carries the RN* entries
# too, but they are dead for its ViT configs — SURVEY §2.1 #4)
CLIP_CHECKPOINT_URLS = {
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/"
                "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/"
                "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/"
                "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/"
                      "3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}

_CHUNK = 1 << 20


def default_cache_dir() -> str:
    return os.environ.get("NRTPU_CLIP_CACHE",
                          os.path.expanduser("~/.cache/nrtpu/clip"))


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(_CHUNK)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def _stat_tag(path: str) -> str:
    st = os.stat(path)
    return f"{st.st_size}-{st.st_mtime_ns}"


def _is_verified(target: str, expected_sha: str) -> bool:
    """True when `target` was digest-verified in the state it is in now.

    A sidecar marker records (sha, size, mtime) at verification time, so
    steady-state startups skip re-hashing a GB-scale file (the reference
    re-hashes on every call, module_clip.py:63); any modification to the
    file invalidates the marker and forces a fresh digest check."""
    marker = target + ".verified"
    try:
        recorded = open(marker).read().split()
    except OSError:
        recorded = None
    if recorded == [expected_sha, _stat_tag(target)]:
        return True
    if _sha256_file(target) != expected_sha:
        return False
    with open(marker, "w") as f:
        f.write(f"{expected_sha} {_stat_tag(target)}")
    return True


def ensure_clip_checkpoint(backbone: str,
                           cache_dir: Optional[str] = None,
                           url: Optional[str] = None,
                           progress: bool = True,
                           timeout: float = 60.0) -> str:
    """Local path to `backbone`'s published OpenAI .pt, fetching on first
    use.  Cached files are digest-checked before reuse (memoized via a
    stat-keyed sidecar marker) and silently re-fetched on mismatch."""
    url = url or CLIP_CHECKPOINT_URLS.get(backbone)
    if url is None:
        raise ValueError(
            f"no published checkpoint for backbone {backbone!r}; available: "
            f"{sorted(CLIP_CHECKPOINT_URLS)} — or pass --clip_checkpoint "
            "with a local .pt path")
    parts = url.rstrip("/").split("/")
    expected_sha, filename = parts[-2], parts[-1]
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    target = os.path.join(cache_dir, filename)
    if os.path.isfile(target):
        if _is_verified(target, expected_sha):
            return target
        os.remove(target)

    import urllib.error
    import urllib.request

    digest = hashlib.sha256()
    fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix=filename + ".part-")
    try:
        with os.fdopen(fd, "wb") as out:
            try:
                # timeout applies to connect AND each read (socket timeout)
                src = urllib.request.urlopen(url, timeout=timeout)
            except (urllib.error.URLError, OSError) as e:
                raise RuntimeError(
                    f"could not fetch {filename} from {url} ({e}); on an "
                    "offline machine, download it elsewhere and pass "
                    "--clip_checkpoint /path/to/" + filename) from e
            with src:
                total = int(src.headers.get("Content-Length") or 0)
                done = 0
                while True:
                    buf = src.read(_CHUNK)
                    if not buf:
                        break
                    digest.update(buf)
                    out.write(buf)
                    done += len(buf)
                    if progress and total:
                        print(f"\rfetching {filename}: {done >> 20}/"
                              f"{total >> 20} MiB", end="", file=sys.stderr,
                              flush=True)
        if progress and total:
            print(file=sys.stderr)
        if digest.hexdigest() != expected_sha:
            raise RuntimeError(
                f"{url}: sha256 mismatch after download "
                f"(got {digest.hexdigest()}, want {expected_sha})")
        os.replace(tmp, target)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    with open(target + ".verified", "w") as f:
        f.write(f"{expected_sha} {_stat_tag(target)}")
    return target
