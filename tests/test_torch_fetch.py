"""The port's CLIP fetch-and-cache (neighborretr_tpu_torch/models/fetch.py)
through the cases of tests/test_fetch.py, with the URL opener stubbed: a
fake zoo in memory answers, so no test opens a URL or a socket.
"""

import hashlib
import io
import os
import urllib.request

import pytest

from neighborretr_tpu.models import fetch as jfetch
from neighborretr_tpu_torch.cli import common
from neighborretr_tpu_torch.models import fetch

# a file URL that names no file: were the stub ever bypassed, the open
# would fail on the local disk
ZOO = "file:///nonexistent/clip/models"


class _Response(io.BytesIO):
    def __init__(self, payload: bytes):
        super().__init__(payload)
        self.headers = {"Content-Length": str(len(payload))}


@pytest.fixture
def zoo(monkeypatch):
    """A stubbed opener over a dict of URL → payload; records each open."""
    files, opened = {}, []

    def urlopen(url, timeout=None):
        opened.append(url)
        return _Response(files[url])

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)

    def publish(payload: bytes, sha: str = None, name="Tiny.pt"):
        sha = sha or hashlib.sha256(payload).hexdigest()
        url = f"{ZOO}/{sha}/{name}"
        files[url] = payload
        return url
    return publish, opened


def test_fetch_caches_and_verifies(tmp_path, zoo):
    publish, opened = zoo
    payload = os.urandom(4096)
    url = publish(payload)
    cache = str(tmp_path / "cache")
    got = fetch.ensure_clip_checkpoint("ViT-B/32", cache_dir=cache, url=url,
                                       progress=False)
    assert open(got, "rb").read() == payload
    assert os.path.dirname(got) == cache
    assert opened == [url]
    # the second call is a cache hit: the opener is not called
    again = fetch.ensure_clip_checkpoint("ViT-B/32", cache_dir=cache,
                                         url=url, progress=False)
    assert again == got and opened == [url]


def test_fetch_refetches_corrupt_cache_entry(tmp_path, zoo):
    publish, opened = zoo
    payload = os.urandom(4096)
    url = publish(payload)
    cache = str(tmp_path / "cache")
    got = fetch.ensure_clip_checkpoint("ViT-B/32", cache_dir=cache, url=url,
                                       progress=False)
    with open(got, "wb") as f:
        f.write(b"corrupted")
    again = fetch.ensure_clip_checkpoint("ViT-B/32", cache_dir=cache,
                                         url=url, progress=False)
    assert open(again, "rb").read() == payload
    assert opened == [url, url]


def test_fetch_rejects_sha_mismatch_and_leaves_no_debris(tmp_path, zoo):
    publish, _ = zoo
    wrong = hashlib.sha256(b"something else").hexdigest()
    url = publish(os.urandom(4096), sha=wrong)
    cache = str(tmp_path / "cache")
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        fetch.ensure_clip_checkpoint("ViT-B/32", cache_dir=cache, url=url,
                                     progress=False)
    assert os.listdir(cache) == []  # no target, no .part leftovers


def test_unknown_backbone_lists_available():
    with pytest.raises(ValueError, match="ViT-B/32"):
        fetch.ensure_clip_checkpoint("RN50x64")


def test_zoo_urls_carry_sha_component_and_match_jax(monkeypatch):
    for name, url in fetch.CLIP_CHECKPOINT_URLS.items():
        sha = url.rstrip("/").split("/")[-2]
        assert len(sha) == 64 and int(sha, 16) >= 0, (name, url)
    assert fetch.CLIP_CHECKPOINT_URLS == jfetch.CLIP_CHECKPOINT_URLS
    # one cache serves both packages
    monkeypatch.setenv("NRTPU_CLIP_CACHE", "/somewhere/clip")
    assert fetch.default_cache_dir() == jfetch.default_cache_dir()
    monkeypatch.delenv("NRTPU_CLIP_CACHE")
    assert fetch.default_cache_dir() == jfetch.default_cache_dir()


def test_cache_hit_skips_rehash(tmp_path, zoo, monkeypatch):
    """Steady-state startups do not re-hash the GB-scale file: the sidecar
    marker memoizes the verified digest keyed on (size, mtime)."""
    publish, _ = zoo
    url = publish(os.urandom(4096))
    cache = str(tmp_path / "cache")
    fetch.ensure_clip_checkpoint("ViT-B/32", cache_dir=cache, url=url,
                                 progress=False)

    def no_hash(path):  # pragma: no cover - would fail the test
        raise AssertionError("re-hashed a marker-verified cache entry")

    monkeypatch.setattr(fetch, "_sha256_file", no_hash)
    fetch.ensure_clip_checkpoint("ViT-B/32", cache_dir=cache, url=url,
                                 progress=False)


class _Args:
    def __init__(self, **kw):
        self.clip_checkpoint = None
        self.datatype = "msrvtt"
        self.tiny = False
        self.base_encoder = "ViT-B/32"
        self.__dict__.update(kw)


def test_resolve_clip_checkpoint_paths(monkeypatch):
    """The CLIs' resolution (cli/common.py): 'random' opts out; supplied
    weights suppress the fetch; synthetic/tiny skip; a file-based dataset
    otherwise fetches; a CLI that names no dataset (search, serve) keeps
    the seeded random weights."""
    a = _Args(clip_checkpoint="random")
    common.resolve_clip_checkpoint(a, weights_already_supplied=False)
    assert a.clip_checkpoint is None and not common.tiny_requested(a)

    fetched = []
    monkeypatch.setattr(fetch, "ensure_clip_checkpoint",
                        lambda name, **kw: fetched.append(name) or "/x.pt")

    a = _Args()
    common.resolve_clip_checkpoint(a, weights_already_supplied=True)
    assert a.clip_checkpoint is None and fetched == []

    for quiet in (_Args(datatype="synthetic"), _Args(tiny=True)):
        common.resolve_clip_checkpoint(quiet, weights_already_supplied=False)
        assert quiet.clip_checkpoint is None and fetched == []
        assert common.tiny_requested(quiet)

    no_dataset = _Args()
    del no_dataset.datatype
    common.resolve_clip_checkpoint(no_dataset, weights_already_supplied=False)
    assert no_dataset.clip_checkpoint is None and fetched == []

    a = _Args()
    common.resolve_clip_checkpoint(a, weights_already_supplied=False)
    assert a.clip_checkpoint == "/x.pt" and fetched == ["ViT-B/32"]

    a = _Args(clip_checkpoint="mine.pt")
    common.resolve_clip_checkpoint(a, weights_already_supplied=False)
    assert a.clip_checkpoint == "mine.pt" and fetched == ["ViT-B/32"]
