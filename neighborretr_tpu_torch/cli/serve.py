"""HTTP retrieval service over a precomputed video index, on the port
(↔ cli/serve.py).

    python -m neighborretr_tpu_torch.cli.serve --index index.npz \
        --checkpoint best.npz --port 8080 [--device cuda|cpu]

The daemon form of `cli.search`: the weights and the corpus features stay
on the device, the query path is warmed up before the port is bound
(`serving.Searcher.warmup`: the kernel libraries' build and load, cuBLAS's
handles), and concurrent requests merge into one device call behind a
`serving.BatchingDispatcher` (`--batch_window_ms 0` serialises them through
a lock instead).  The bound address is logged, so `--port 0` can be driven.

JSON API (stdlib http.server, threaded):
  GET  /healthz                     → {"status":"ok","videos":N,...}
  GET  /search?q=<text>[&topk=K]    → single-query convenience
  POST /search  {"queries": ["..."], "topk": K}
  POST /reload                      → re-read --index and swap it in live
Response: {"results": [[{"video_id": id, "score": s}, ...], ...]}
Errors are JSON with HTTP 400/404/409/413.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

MAX_QUERIES_PER_REQUEST = 256
MAX_BODY_BYTES = 1 << 20  # 1 MiB of JSON is already ~4k captions


def make_handler(searcher, default_topk: int = 5, logger=None,
                 dispatcher=None, reload_fn=None):
    """Handler class closed over a serving.Searcher.

    Without a dispatcher, requests serialize through one lock (each request
    has the card to itself, and host-side result memory stays bounded);
    with a `serving.BatchingDispatcher`, concurrent requests merge into one
    device call instead.

    reload_fn (optional): builds a fresh Searcher from the index on disk;
    POST /reload swaps it in live.  The fresh Searcher is built and warmed
    outside the request lock (searches go on against the old corpus); a
    failed reload keeps the old searcher serving and answers 409."""
    lock = threading.Lock()
    reload_lock = threading.Lock()   # serializes reloads; never blocks search
    state = {"searcher": searcher}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str) -> None:
            self._reply(code, {"error": message})

        def _run_search(self, queries, topk) -> None:
            if not isinstance(queries, list) or not queries or \
                    not all(isinstance(q, str) for q in queries):
                return self._error(400, "queries must be a non-empty "
                                        "list of strings")
            if len(queries) > MAX_QUERIES_PER_REQUEST:
                return self._error(413, f"at most {MAX_QUERIES_PER_REQUEST} "
                                        "queries per request")
            try:
                topk = int(topk)
            except (TypeError, ValueError):
                return self._error(400, "topk must be an integer")
            if topk < 1:
                return self._error(400, "topk must be >= 1")
            if dispatcher is not None:
                results = dispatcher.submit(queries, topk)
            else:
                with lock:
                    results = state["searcher"].search(queries, topk=topk)
            self._reply(200, {"results": [
                [{"video_id": vid, "score": score} for vid, score in hits]
                for hits in results]})

        def do_GET(self):  # noqa: N802 (http.server contract)
            url = urlparse(self.path)
            if url.path == "/healthz":
                s = state["searcher"]
                return self._reply(200, {
                    "status": "ok", "videos": len(s),
                    "query_batch": s.query_batch})
            if url.path == "/search":
                q = parse_qs(url.query)
                queries = q.get("q")
                topk = q.get("topk", [default_topk])[-1]
                if not queries:
                    return self._error(400, "missing q= query parameter")
                return self._run_search(queries, topk)
            self._error(404, f"unknown path {url.path!r}; use /healthz "
                             "or /search")

        def _drain(self, length: int) -> None:
            """Consume an unread request body so a keep-alive connection
            stays in sync after an early-exit reply."""
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 16))
                if not chunk:
                    break
                length -= len(chunk)

        def do_POST(self):  # noqa: N802
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                self.close_connection = True    # cannot find the body's end
                return self._error(400, "invalid Content-Length header")
            if length < 0:
                self.close_connection = True
                return self._error(400, "invalid Content-Length header")
            path = urlparse(self.path).path
            if path == "/reload":
                if length > MAX_BODY_BYTES:   # /reload takes no body
                    self.close_connection = True
                    return self._error(413, "request body too large")
                self._drain(length)
                if reload_fn is None:
                    return self._error(404, "reload not configured")
                try:
                    with reload_lock:
                        fresh = reload_fn()
                        with lock:
                            state["searcher"] = fresh
                            if dispatcher is not None:
                                dispatcher.searcher = fresh
                except Exception as exc:
                    return self._error(409, f"reload failed: {exc}")
                return self._reply(200, {"status": "reloaded",
                                         "videos": len(state["searcher"])})
            if path != "/search":
                self._drain(length)
                return self._error(404, "POST /search or /reload only")
            if length > MAX_BODY_BYTES:
                # draining an arbitrarily large body is a DoS vector
                self.close_connection = True
                return self._error(413, "request body too large")
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                return self._error(400, f"invalid JSON: {e}")
            if not isinstance(body, dict):
                return self._error(400, "body must be a JSON object")
            self._run_search(body.get("queries"),
                             body.get("topk", default_topk))

        def log_message(self, fmt, *args):
            if logger is not None:
                logger.info("%s %s", self.address_string(), fmt % args)

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 resets connections under a burst of
    # concurrent clients, the traffic dynamic batching serves
    request_queue_size = 128


def make_server(searcher, host: str = "127.0.0.1", port: int = 0,
                default_topk: int = 5, logger=None,
                dispatcher=None, reload_fn=None) -> ThreadingHTTPServer:
    """Bound-but-not-serving HTTP server (port 0: an ephemeral port)."""
    return _Server(
        (host, port),
        make_handler(searcher, default_topk, logger, dispatcher=dispatcher,
                     reload_fn=reload_fn))


def main(argv=None):
    p = argparse.ArgumentParser(description="Video retrieval HTTP service")
    p.add_argument("--index", required=True, help="index .npz (cli.index)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--topk", type=int, default=5, help="default result count")
    p.add_argument("--query_batch", type=int, default=8,
                   help="request batches pad up to a multiple of this")
    p.add_argument("--batch_window_ms", type=float, default=2.0,
                   help="dynamic batching: merge concurrent requests "
                        "arriving within this window into one device call; "
                        "0 serializes requests through a lock")
    p.add_argument("--max_merged_queries", type=int, default=None,
                   help="cap on the merged query count per device call "
                        "(default: 8x query_batch, min 64)")
    p.add_argument("--num_devices", type=int, default=1,
                   help="shard the corpus over this many devices of this "
                        "process (cuda:0..N-1, or the CPU N times under "
                        "--device cpu): one shard a device, the top-k "
                        "merged; for indexes that outgrow one device")
    p.add_argument("--reload_stage_rows", type=int, default=512,
                   help="POST /reload uploads the fresh corpus in row slabs "
                        "of this size on a side stream, so searches "
                        "interleave with the transfer (0 = one copy)")
    from .common import add_model_args
    add_model_args(p)
    args = p.parse_args(argv)
    if args.num_devices < 1:
        raise SystemExit(f"--num_devices {args.num_devices}: need at least "
                         "one device")

    from ..data.tokenizer import ClipTokenizer

    from .. import serving
    from .common import load_query_model, resolve_device, setup_logger

    logger = setup_logger()
    device = resolve_device(args.device)
    devices = None
    if args.num_devices > 1:
        from ..parallel.mesh import take_devices
        devices = take_devices(args.num_devices, device.type)
        device = devices[0]
        logger.info("Sharding the corpus over %d devices", args.num_devices)
    index = serving.load_index(args.index)
    cfg, model = load_query_model(args, index, device, logger)
    tok = ClipTokenizer()

    searcher = serving.Searcher(model, cfg, index, tok,
                                query_batch=args.query_batch, devices=devices)
    dispatcher = None
    if args.batch_window_ms > 0:
        dispatcher = serving.BatchingDispatcher(
            searcher, max_batch=args.max_merged_queries,
            max_wait_ms=args.batch_window_ms)
        logger.info("Dynamic batching: window %.1f ms, up to %d merged "
                    "queries per device call", args.batch_window_ms,
                    dispatcher.max_batch)

    def warm(s):
        """Pay everything a first request would wait on, each merged
        bucket's shapes included."""
        s.warmup()
        for b in dispatcher.buckets if dispatcher is not None else ():
            s.search(["warmup"] * b, topk=args.topk)

    logger.info("Index: %d videos on %s; warming up the query path ...",
                len(searcher), device)
    warm(searcher)

    def reload_fn():
        """POST /reload: re-read --index (grown by `cli.index --append`) into
        a fresh, warmed Searcher, uploaded in slabs; check_meta refuses an
        index built with other weights or another config."""
        fresh = serving.Searcher(model, cfg, serving.load_index(args.index),
                                 tok, query_batch=args.query_batch,
                                 staged_upload_rows=args.reload_stage_rows,
                                 devices=devices)
        warm(fresh)
        logger.info("Reloaded index: %d videos", len(fresh))
        return fresh

    server = make_server(searcher, args.host, args.port,
                         default_topk=args.topk, logger=logger,
                         dispatcher=dispatcher, reload_fn=reload_fn)
    logger.info("Serving on http://%s:%d (GET /healthz, GET|POST /search, "
                "POST /reload)", *server.server_address)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down")
    finally:
        server.server_close()
        if dispatcher is not None:
            dispatcher.close()


if __name__ == "__main__":
    main()
