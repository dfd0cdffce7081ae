"""The port's serving daemon against the JAX package (tiny config, fp32, on
the CPU): `append_index`, the staged upload, `BatchingDispatcher`, the HTTP
handler with live reload, and the `cli.index --append` / `cli.serve`
entry points.

Tolerances: hits are held to the JAX `Searcher`'s with scores within atol
1e-4 and ranks swapping only between near-ties (1e-4 apart), as
tests/test_torch_serving.py holds search; the port against itself (a
staged upload, the dispatcher against sequential search) is held to the
bit, or to pytest.approx's 1e-6 relative where the JAX test uses it."""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
from urllib.parse import quote

from neighborretr_tpu import serving as jserving
from neighborretr_tpu.core.config import Config, ModelConfig
from neighborretr_tpu.data.datasets.synthetic import SyntheticDataset
from neighborretr_tpu.data.loader import BatchLoader
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu_torch import serving as pserving
from neighborretr_tpu_torch.cli.serve import make_server
from neighborretr_tpu_torch.core import config as pconfig
from neighborretr_tpu_torch.models import weights_io as W

from test_torch_serving import StubTokenizer, assert_same_hits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Wd, F, N = 8, 4, 24
PCFG = pconfig.Config(model=pconfig.ModelConfig.tiny(max_words=Wd,
                                                     max_frames=F))
QUERIES = ["a cat plays piano", "someone rides a bike downhill"]


@pytest.fixture(scope="module")
def setup():
    cfg = Config(model=ModelConfig.tiny(max_words=Wd, max_frames=F))
    ds = SyntheticDataset(n=N, seed=3, max_words=Wd, max_frames=F,
                          resolution=cfg.model.clip.image_resolution,
                          vocab_size=cfg.model.clip.vocab_size)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), cfg.model))
    model = W.from_jax_params(params, PCFG.model)

    def loader():
        return BatchLoader(ds, 8, shuffle=False, drop_last=False, workers=0,
                           pad_to_batch=True)

    index = pserving.build_video_index(model, PCFG, loader(), dataset=ds)
    return cfg, ds, params, model, loader, index


def test_append_index_matches_jax(setup):
    """On the same inputs the port's append_index gives the JAX one's
    arrays; a port build in two parts merges to the whole build."""
    cfg, ds, params, model, loader, full = setup
    have = [str(v) for v in full["video_ids"]]
    first, rest = set(have[:5]), set(have[5:])
    part = pserving.build_video_index(model, PCFG, loader(), dataset=ds,
                                      skip_ids=rest)
    assert list(part["video_ids"]) == have[:5]
    new = pserving.build_video_index(model, PCFG, loader(), dataset=ds,
                                     skip_ids=first - {have[0]})
    assert list(new["video_ids"]) == have[:1] + have[5:]   # one overlap
    q8 = {}
    for name, idx in (("part", part), ("new", new)):
        q8[name] = dict(idx)
        q8[name]["v_feat"], q8[name]["v_scale"] = pserving.quantize_features(
            idx["v_feat"])
    for a, b in ((part, new), (q8["part"], q8["new"])):
        got = pserving.append_index(a, b)
        want = jserving.append_index(a, b)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert list(got["video_ids"]) == have
    merged = pserving.append_index(part, new)
    for key in ("v_feat", "v_mask", "meta"):
        np.testing.assert_array_equal(merged[key], full[key])
    # appending the same rows again is a no-op
    assert pserving.append_index(merged, new) is merged
    assert jserving.append_index(merged, new) is merged


def test_append_index_refusals_match_jax(setup):
    *_, full = setup
    other = dict(full)
    other["meta"] = np.frombuffer(b'{"different": true}', dtype=np.uint8)
    quant = dict(full)
    quant["v_feat"], quant["v_scale"] = pserving.quantize_features(
        full["v_feat"])
    for bad, match in ((other, "meta mismatch"), (quant, "feature_dtype")):
        with pytest.raises(ValueError, match=match) as got:
            pserving.append_index(full, bad)
        with pytest.raises(ValueError) as want:
            jserving.append_index(full, bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,rows", [(37, 8), (16, 16), (5, 64), (24, 7),
                                    (3, 0)])
def test_staged_device_put_equals_one_copy(n, rows):
    """Row slabs (an overlapping last slab where rows do not divide n) give
    the array itself, as the JAX staged_device_put does."""
    a = np.random.default_rng(n).normal(size=(n, 4, 6)).astype(np.float16)
    got = pserving.staged_device_put(a, rows, "cpu")
    assert got.dtype.itemsize == 2 and tuple(got.shape) == a.shape
    np.testing.assert_array_equal(got.numpy(), a)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jserving.staged_device_put(a, rows)))
    calls = []
    pserving.staged_device_put(a, rows, "cpu",
                               yield_fn=lambda: calls.append(1))
    assert len(calls) == (0 if rows <= 0 or rows >= n else -(-n // rows))


def test_staged_searcher_scores_as_unstaged(setup):
    """staged_upload_rows serves the unstaged Searcher's similarities to the
    bit, fp16 and int8 indexes alike, and the JAX staged Searcher's within
    1e-4."""
    cfg, _, params, model, _, index = setup
    tok = StubTokenizer()
    q8 = dict(index)
    q8["v_feat"], q8["v_scale"] = pserving.quantize_features(
        np.asarray(index["v_feat"], np.float32))
    for idx in (index, q8):
        base = pserving.Searcher(model, PCFG, idx, tok, query_batch=4)
        staged = pserving.Searcher(model, PCFG, idx, tok, query_batch=4,
                                   staged_upload_rows=5)
        np.testing.assert_array_equal(base.similarities(QUERIES),
                                      staged.similarities(QUERIES))
        want = jserving.Searcher(params, cfg, idx, tok, query_batch=4,
                                 staged_upload_rows=5)
        np.testing.assert_allclose(staged.similarities(QUERIES),
                                   want.similarities(QUERIES), atol=1e-4,
                                   rtol=0)


class CountingSearcher:
    """Fake Searcher: per-query deterministic hits and a call log (the JAX
    suite's _CountingSearcher)."""

    def __init__(self, query_batch=4):
        self.query_batch = query_batch
        self.calls = []
        self._gate = threading.Event()
        self._gate.set()

    def search(self, queries, topk=5):
        self._gate.wait()
        self.calls.append((len(queries), topk))
        return [[(f"vid_{q}_{r}", float(len(q) + r)) for r in range(topk)]
                for q in queries]


def _concurrent(d, requests, searcher):
    """Submit each (queries, topk) from its own thread while the fake
    device is held, then release it → results by request."""
    searcher._gate.clear()
    results = {}

    def worker(i, queries, topk):
        results[i] = d.submit(queries, topk)

    threads = [threading.Thread(target=worker, args=(i, *r))
               for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    searcher._gate.set()
    for t in threads:
        t.join(timeout=30)
    return results


def test_dispatcher_routes_and_slices():
    """Concurrent submits merge into fewer calls at the batch's largest
    topk; each caller gets its own queries' hits at its own topk."""
    s = CountingSearcher()
    d = pserving.BatchingDispatcher(s, max_wait_ms=200.0)
    try:
        requests = [([f"q{i}a", f"q{i}b"], 2 + i % 3) for i in range(6)]
        results = _concurrent(d, requests, s)
        assert len(results) == 6
        for i, (queries, k) in enumerate(requests):
            assert results[i] == [[(f"vid_{q}_{r}", float(len(q) + r))
                                   for r in range(k)] for q in queries]
        assert len(s.calls) < 6
        assert sum(n for n, _ in s.calls) >= 12
        assert all(k <= 4 for _, k in s.calls)
        assert d.requests == 6 and d.batches == len(s.calls)
    finally:
        d.close()


def test_dispatcher_passes_errors_to_every_caller():
    class Boom:
        query_batch = 4

        def search(self, queries, topk=5):
            time.sleep(0.2)
            raise RuntimeError("device fell over")

    d = pserving.BatchingDispatcher(Boom(), max_wait_ms=100.0)
    errors = []

    def worker():
        try:
            d.submit(["q"], topk=1)
        except RuntimeError as e:
            errors.append(str(e))

    try:
        threads = [threading.Thread(target=worker) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert errors == ["device fell over"] * 3
        assert d.requests == 3
    finally:
        d.close()


def test_dispatcher_max_batch_buckets_and_carry():
    """One oversized request goes alone; merges pad to power-of-two
    multiples of query_batch; a request that would overflow max_batch
    starts the next batch."""
    s = CountingSearcher()
    d = pserving.BatchingDispatcher(s, max_batch=3, max_wait_ms=50.0)
    try:
        assert len(d.submit(["a", "b", "c", "d"], topk=1)) == 4
        assert s.calls[-1][0] == 4
    finally:
        d.close()
    s = CountingSearcher(query_batch=4)
    d = pserving.BatchingDispatcher(s, max_batch=32, max_wait_ms=0.0)
    try:
        assert d.buckets == [4, 8, 16, 32]
        out = d.submit(["alpha", "beta", "gamma", "delta", "epsilon"], topk=2)
        assert len(out) == 5 and s.calls[-1][0] == 8
        assert out[0][0][0] == "vid_alpha_0"
    finally:
        d.close()
    s = CountingSearcher(query_batch=4)
    d = pserving.BatchingDispatcher(s, max_batch=4, max_wait_ms=200.0)
    try:
        results = _concurrent(
            d, [([f"q{i}x", f"q{i}y", f"q{i}z"], 1) for i in range(3)], s)
        assert len(results) == 3
        assert [n for n, _ in s.calls] == [4, 4, 4]
    finally:
        d.close()


def test_dispatcher_close_fails_queued_and_later_submits():
    s = CountingSearcher()
    d = pserving.BatchingDispatcher(s, max_wait_ms=1.0)
    d.close()
    with pytest.raises(RuntimeError, match="closed"):
        d.submit(["q"], topk=1)
    # a request that raced past the closed check into the queue behind
    # close()'s sentinel is failed by close(), not left hanging
    s = CountingSearcher()
    s._gate.clear()
    d = pserving.BatchingDispatcher(s, max_wait_ms=0.0)
    first = threading.Thread(target=d.submit, args=(["a"], 1))
    first.start()
    time.sleep(0.2)                 # "a" is on the (held) device
    closer = threading.Thread(target=d.close)
    closer.start()
    time.sleep(0.2)                 # the sentinel is queued
    late = pserving._Pending(["b"], 1)
    d._queue.put(late)
    s._gate.set()
    closer.join(timeout=30)
    first.join(timeout=30)
    assert s.calls == [(4, 1)]
    assert late.event.is_set() and "closed" in str(late.error)


class Server:
    """make_server on an ephemeral port, served from a thread."""

    def __init__(self, searcher, **kw):
        self.server = make_server(searcher, "127.0.0.1", 0, **kw)
        self.host, self.port = self.server.server_address
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection(self.host, self.port, timeout=60)
        conn.request(method, path, json.dumps(body) if body else None,
                     {"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read().decode())
        conn.close()
        return out

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def hits_of(payload):
    return [[(h["video_id"], h["score"]) for h in row]
            for row in payload["results"]]


def test_http_round_trip_against_jax(setup):
    """healthz, GET and POST search against the JAX Searcher's hits, and
    the JSON errors 400/404/413."""
    cfg, _, params, model, _, index = setup
    tok = StubTokenizer()
    searcher = pserving.Searcher(model, PCFG, index, tok, query_batch=4)
    want = jserving.Searcher(params, cfg, index, tok,
                             query_batch=4).search(QUERIES, topk=3)
    srv = Server(searcher, default_topk=3)
    try:
        status, health = srv.request("GET", "/healthz")
        assert status == 200 and health["videos"] == N
        assert health["query_batch"] == 4
        status, got = srv.request("POST", "/search",
                                  {"queries": QUERIES, "topk": 3})
        assert status == 200
        assert_same_hits(hits_of(got), want)
        assert hits_of(got) == searcher.search(QUERIES, topk=3)
        status, got1 = srv.request(
            "GET", f"/search?q={quote(QUERIES[0])}&topk=3")
        assert status == 200
        assert_same_hits(hits_of(got1), want[:1])
        assert srv.request("POST", "/search", {"queries": []})[0] == 400
        assert srv.request("POST", "/search",
                           {"queries": "not-a-list"})[0] == 400
        assert srv.request("POST", "/search",
                           {"queries": ["x"], "topk": "NaN"})[0] == 400
        assert srv.request("POST", "/search",
                           {"queries": ["x"], "topk": 0})[0] == 400
        assert srv.request("GET", "/search")[0] == 400
        assert srv.request("GET", "/nope")[0] == 404
        assert srv.request("POST", "/search", {"queries": ["q"] * 257})[0] \
            == 413
        assert srv.request("POST", "/reload")[0] == 404   # not configured
    finally:
        srv.close()


def test_http_keepalive_resync_after_early_errors(setup):
    """A 404 on a wrong POST path drains its body, so the same keep-alive
    connection serves the next request; a malformed Content-Length gets a
    JSON 400 and a closed connection."""
    *_, model, _, index = setup
    searcher = pserving.Searcher(model, PCFG, index, StubTokenizer(),
                                 query_batch=4)
    srv = Server(searcher, default_topk=2)
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        body = json.dumps({"queries": ["resync probe"], "topk": 1})
        conn.request("POST", "/nope", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.request("POST", "/search", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert len(json.loads(resp.read().decode())["results"]) == 1
        conn.close()
        raw = socket.create_connection((srv.host, srv.port), timeout=30)
        raw.sendall(b"POST /search HTTP/1.1\r\nHost: x\r\n"
                    b"Content-Length: abc\r\n\r\n")
        chunks = []
        while True:
            got = raw.recv(65536)
            if not got:
                break
            chunks.append(got)
        reply = b"".join(chunks).decode()
        assert "400" in reply.split("\r\n")[0]
        assert "invalid Content-Length" in reply
        raw.close()
    finally:
        srv.close()


def test_http_dispatcher_matches_sequential(setup):
    """Concurrent single-query requests through the dispatcher answer what
    sequential searches answer (pytest.approx, as the JAX test), and the
    JAX Searcher's hits within 1e-4."""
    cfg, _, params, model, _, index = setup
    tok = StubTokenizer()
    searcher = pserving.Searcher(model, PCFG, index, tok, query_batch=4)
    queries = [f"synthetic caption number {i}" for i in range(8)]
    want = searcher.search(queries, topk=3)
    want_jax = jserving.Searcher(params, cfg, index, tok,
                                 query_batch=4).search(queries, topk=3)
    dispatcher = pserving.BatchingDispatcher(searcher, max_wait_ms=25.0)
    srv = Server(searcher, default_topk=3, dispatcher=dispatcher)
    try:
        got = [None] * len(queries)

        def one(i):
            got[i] = srv.request("POST", "/search",
                                 {"queries": [queries[i]], "topk": 3})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, (status, payload) in enumerate(got):
            assert status == 200, payload
            assert payload["results"] == [
                [{"video_id": vid, "score": pytest.approx(score)}
                 for vid, score in want[i]]]
            assert_same_hits(hits_of(payload), want_jax[i:i + 1])
        assert dispatcher.requests == len(queries)
        assert dispatcher.batches < dispatcher.requests
    finally:
        srv.close()
        dispatcher.close()


def test_http_reload_swaps_index_live(setup, tmp_path):
    """POST /reload picks up a grown index without a restart (staged upload,
    through the dispatcher) and ranks as the JAX Searcher over it; a reload
    of an index built with other weights answers 409 and keeps the old
    corpus serving."""
    cfg, ds, params, model, loader, full = setup
    tok = StubTokenizer()
    have = [str(v) for v in full["video_ids"]]
    half = pserving.build_video_index(model, PCFG, loader(), dataset=ds,
                                      skip_ids=set(have[len(have) // 2:]))
    path = pserving.save_index(str(tmp_path / "live"), half)

    def reload_fn():
        return pserving.Searcher(model, PCFG, pserving.load_index(path), tok,
                                 query_batch=4, staged_upload_rows=5)

    searcher = pserving.Searcher(model, PCFG, pserving.load_index(path), tok,
                                 query_batch=4)
    dispatcher = pserving.BatchingDispatcher(searcher, max_wait_ms=1.0)
    srv = Server(searcher, default_topk=3, dispatcher=dispatcher,
                 reload_fn=reload_fn)
    try:
        assert srv.request("GET", "/healthz")[1]["videos"] == len(have) // 2
        pserving.save_index(path, full)
        status, out = srv.request("POST", "/reload")
        assert status == 200 and out == {"status": "reloaded",
                                         "videos": len(have)}
        assert srv.request("GET", "/healthz")[1]["videos"] == len(have)
        status, out = srv.request("POST", "/search",
                                  {"queries": QUERIES, "topk": len(have)})
        assert status == 200
        assert {h["video_id"] for h in out["results"][0]} == set(have)
        assert_same_hits(hits_of(out), jserving.Searcher(
            params, cfg, full, tok, query_batch=4).search(QUERIES, len(have)))
        other = W.init_model(PCFG.model, seed=9)
        bad = dict(full)
        bad["meta"] = np.frombuffer(json.dumps(
            pserving._config_meta(PCFG, other)).encode(), dtype=np.uint8)
        pserving.save_index(path, bad)
        status, out = srv.request("POST", "/reload")
        assert status == 409 and "reload failed" in out["error"]
        assert "DIFFERENT CHECKPOINT" in out["error"]
        assert srv.request("GET", "/healthz")[1]["videos"] == len(have)
    finally:
        srv.close()
        dispatcher.close()


def _cli(module, *args, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", f"neighborretr_tpu_torch.cli.{module}",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300, **kw)


TINY = ["--tiny", "--device", "cpu", "--max_words", "8"]


def test_index_cli_append(tmp_path):
    """cli.index --append: the indexed videos are skipped and the new ones
    merged; nothing new leaves the file as it is; another feature dtype
    exits before any forward."""
    out = str(tmp_path / "idx.npz")
    common = ["--datatype", "synthetic", "--out", out, "--batch_size", "8",
              "--max_frames", "4", "--workers", "0", *TINY]
    r = _cli("index", "--synthetic_size", "10", *common)
    assert r.returncode == 0, r.stderr
    first = pserving.load_index(out)
    r = _cli("index", "--synthetic_size", "14", "--append", *common)
    assert r.returncode == 0, r.stderr
    assert "its 10 indexed videos are skipped" in r.stderr
    assert "Appended 4 new videos" in r.stderr
    grown = pserving.load_index(out)
    assert [str(v) for v in grown["video_ids"]] == \
        [f"video{i}" for i in range(14)]
    np.testing.assert_array_equal(grown["v_feat"][:10], first["v_feat"])
    before = open(out, "rb").read()
    r = _cli("index", "--synthetic_size", "14", "--append", *common)
    assert r.returncode == 0, r.stderr
    assert "No new videos to index" in r.stderr
    assert open(out, "rb").read() == before
    r = _cli("index", "--synthetic_size", "16", "--append",
             "--feature_dtype", "int8", *common)
    assert r.returncode != 0 and "--feature_dtype differs" in r.stderr
    assert open(out, "rb").read() == before


def test_index_cli_worker_mode_process_gives_the_thread_index(tmp_path):
    """cli.index --worker_mode process (forked loader workers) writes the
    index that --worker_mode thread writes, array for array."""
    got = {}
    for mode in ("thread", "process"):
        out = str(tmp_path / f"{mode}.npz")
        r = _cli("index", "--datatype", "synthetic", "--synthetic_size", "12",
                 "--out", out, "--batch_size", "8", "--max_frames", "4",
                 "--workers", "2", "--worker_mode", mode, *TINY)
        assert r.returncode == 0, r.stderr
        got[mode] = pserving.load_index(out)
    assert got["thread"].keys() == got["process"].keys()
    for k, v in got["thread"].items():
        np.testing.assert_array_equal(got["process"][k], v, err_msg=k)


def test_serve_cli(tmp_path):
    """cli.serve --port 0 on the CPU, the corpus sharded over two devices
    (the CPU twice): the bound address in the log, healthz and a search,
    POST /reload after an --append, SIGINT exits 0; --num_devices 0 exits
    with the reason."""
    out = str(tmp_path / "idx.npz")
    common = ["--datatype", "synthetic", "--out", out, "--batch_size", "8",
              "--max_frames", "4", "--workers", "0", *TINY]
    assert _cli("index", "--synthetic_size", "6", *common).returncode == 0
    r = _cli("serve", "--index", out, "--num_devices", "0", *TINY)
    assert r.returncode != 0 and "at least one device" in r.stderr
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "neighborretr_tpu_torch.cli.serve", "--index",
         out, "--port", "0", "--query_batch", "2", "--reload_stage_rows",
         "2", "--num_devices", "2", *TINY], cwd=ROOT, env=env,
        stderr=subprocess.PIPE, text=True)
    try:
        port = None
        lines = []
        deadline = time.monotonic() + 240
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "Serving on http://" in line:
                port = int(line.rsplit(":", 1)[1].split()[0])
        assert port is not None, "".join(lines)
        threading.Thread(target=proc.stderr.read, daemon=True).start()

        def request(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request(method, path, json.dumps(body) if body else None,
                         {"Content-Type": "application/json"} if body else {})
            resp = conn.getresponse()
            result = resp.status, json.loads(resp.read().decode())
            conn.close()
            return result

        assert request("GET", "/healthz")[1]["videos"] == 6
        status, got = request("POST", "/search",
                              {"queries": ["a dog"], "topk": 3})
        assert status == 200 and len(got["results"][0]) == 3
        assert _cli("index", "--synthetic_size", "9", "--append",
                    *common).returncode == 0
        assert request("POST", "/reload") == (200, {"status": "reloaded",
                                                    "videos": 9})
        assert request("GET", "/healthz")[1]["videos"] == 9
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
