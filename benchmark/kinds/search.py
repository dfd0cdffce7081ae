"""Search cells: free-text queries from closed-loop clients through the
program's `BatchingDispatcher` over a `Searcher` that holds the whole index
on the card.

Set-up makes the index rows on the card from the seed (float16, as an
index file keeps them), hands them to a `Searcher` (which widens them to
float32 on the card), starts the dispatcher, warms every merged batch
size the dispatcher can form and moves what set-up made into the garbage
collector's permanent generation.  In the window `clients` threads each
send one query at a time and wait for its top-k reply.  queries/s = replies
received by the window's end / the window; the p95 is over every request
sent in the window, from submit to reply on the client's clock, those still
open at the end waited for (a minute at most); a request that fails or
never returns counts as missing every limit.

Once the window has closed, a sample of the answered requests drawn from
the seed, the longest queries among them, is judged by the reference
(reference/search.py: its own tokenizer, float32 text tower, the
similarity against every video of the index made again from the seed).
The tower's bf16 rounding moves a score by about 1e-3, which would hide a
similarity computed below float32; so the check also follows the program
past its text tower: the features each judged request was served from,
recorded in the window, and the float64 similarity of those against the
videos returned (`sim_gap`).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import random
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..harness import compare, core, port, readers, trace
from ..reference import search as RS
from ..reference.precision import Precision, set_float32_exact
from ..reference.tokenizer import Tokenizer


def _index_dict(feat, mask, cfg, model):
    """The index as an index file holds it (`serving.build_video_index`'s
    layout), its meta naming the model's configuration and weights."""
    from neighborretr_tpu_torch import serving
    meta = {"embed_dim": cfg.model.clip.embed_dim,
            "max_words": cfg.model.max_words,
            "max_frames": cfg.model.max_frames,
            "image_resolution": cfg.model.clip.image_resolution,
            "params_fingerprint": serving.params_fingerprint(model)}
    n = feat.shape[0]
    return {"video_ids": np.asarray([f"v{i}" for i in range(n)]),
            "v_feat": feat.cpu().numpy(), "v_mask": mask.cpu().numpy(),
            "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}


def _faulty(searcher, fault: Optional[str], n_videos: int):
    if fault is None:
        return
    if fault != "altered":
        raise ValueError(f"unknown fault {fault!r}")
    search = searcher.search

    def altered(queries, topk=5):
        out = search(queries, topk)
        for row in out:
            if row:
                vid, s = row[0]
                row[0] = (f"v{(int(vid[1:]) + 1) % n_videos}", s)
        return out

    searcher.search = altered


def run(files: dict, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: Optional[float] = None, fault: Optional[str] = None,
        log=core.log) -> dict:
    from neighborretr_tpu_torch.data.tokenizer import ClipTokenizer
    from neighborretr_tpu_torch.serving import BatchingDispatcher, Searcher

    t = files["traffic"]
    cfg = port.program_config(files)
    rcfg = port.reference_cfg(files)
    model = port.build_model(cfg, seed, device)
    shapes = port.shapes(model)
    gen = core.generator(files)
    feat, mask = gen.make_index(t, cfg.model.width, seed, device)
    index = _index_dict(feat, mask, cfg, model)
    del feat, mask
    searcher = Searcher(model, cfg, index, ClipTokenizer(),
                        query_batch=t["query_batch"])
    del index
    _faulty(searcher, fault, t["videos"])
    queries = gen.make_queries(t, seed)
    disp = BatchingDispatcher(searcher, max_batch=t["max_batch"],
                              max_wait_ms=t["max_wait_ms"])
    try:
        for b in disp.buckets:          # every merged size, through the path
            searcher.search(queries[:b], topk=t["topk"])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        # The window keeps every reply for the check, so the collector would
        # run one full collection in it over all that set-up made as well (a
        # stall of 130-200 ms on the 8-core host of an H100 80GB); a server
        # drops its replies.
        gc.collect()
        gc.freeze()
        setup_s = time.time() - t_start if t_start is not None else 0.0
        log(f"set-up {setup_s:.1f} s; window of {seconds} s")
        with text_features_recorded() as encoded:
            recs = _window(disp, searcher, queries, t, seconds, traced)
    finally:
        disp.close()
        gc.unfreeze()
    prof, t0, t_end, calls = recs.pop("prof"), recs.pop("t0"), \
        recs.pop("t_end"), recs.pop("calls")
    done = recs["done"]
    answered = sum(1 for r in done if r[2] is not None and r[1] <= t_end)
    lat = [(r[1] - r[0]) * 1e3 if r[2] is not None else math.inf
           for r in done]
    attempted = len(done)
    failed = sum(1 for r in done if r[2] is None)
    p95 = _p95(lat)
    dev_info = core.device_info(1) if torch.device(device).type == "cuda" \
        else {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}
    log(f"{answered} answered, {attempted} sent, {failed} failed, "
        f"p95 {p95:.2f} ms, {calls} device calls")

    judged = _sample(done, queries, t, seed)
    served = served_features(judged, queries, encoded, t["max_words"])
    del searcher, disp, model, encoded
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge(judged, queries, files, rcfg, shapes, seed, device,
                    "float32", served)
    limits = files["limits"]
    checks = {k: core.check(numbers[k], limits[k]) for k in limits}
    if not judged:
        checks["judged_requests"] = core.check(0.0, -1.0)
    log("readings: " + ", ".join(f"{k} {v:.4g}" for k, v in numbers.items()))
    out = {"correct": all(c["ok"] for c in checks.values()),
           "attempted": attempted, "failed": failed, "device": dev_info,
           "checks": checks,
           "info": {k: v for k, v in numbers.items() if k not in limits},
           "setup_s": setup_s,
           "queries_per_s": answered / seconds, "p95_ms": p95}
    if traced:
        r = trace.reduce(prof.events)
        out["ctx"] = {"trace": r, "kernels": readers.kernel_entries(),
                      "units": answered, "window_s": seconds,
                      "calls": calls}
        out["reduced"] = r
    return out


def end_to_end(out: dict) -> dict:
    return {"search_queries_per_s": out["queries_per_s"],
            "search_p95_ms": out["p95_ms"], "setup_s": out["setup_s"]}


def _p95(lat):
    s = sorted(lat)
    if not s:
        return math.inf
    return s[min(len(s) - 1, math.ceil(0.95 * len(s)) - 1)]


def _window(disp, searcher, queries, t, seconds, traced):
    """The closed loop: each client sends its next query once the last one
    is answered; records (submit, reply, result or None, query index)."""
    n_cl, topk = t["clients"], t["topk"]
    done, lock = [], threading.Lock()
    start = threading.Barrier(n_cl + 1)
    box = {}

    def client(c):
        j = 0
        out = []
        start.wait()
        t0 = box["t0"]
        while time.perf_counter() - t0 < seconds:
            q = (c + n_cl * j) % len(queries)
            j += 1
            ts = time.perf_counter()
            try:
                res = disp.submit([queries[q]], topk)[0]
            except Exception:          # noqa: BLE001 — a failed request
                res = None
            out.append((ts, time.perf_counter(), res, q))
        with lock:
            done.extend(out)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_cl)]
    for th in threads:
        th.start()
    with trace.profiled(traced) as prof:
        with trace.window_span():
            calls0 = searcher.calls
            box["t0"] = time.perf_counter()
            start.wait()
            time.sleep(seconds)
            t_end = box["t0"] + seconds
            calls = searcher.calls - calls0
            for th in threads:
                th.join(timeout=seconds + 60)
    if any(th.is_alive() for th in threads):
        raise core.BenchError("clients still waiting a minute past the "
                              "window's end")
    return {"prof": prof, "t0": box["t0"], "t_end": t_end, "calls": calls,
            "done": done}


@contextlib.contextmanager
def text_features_recorded():
    """While active, every call of the program's text tower
    (`NeighborRetr.get_text_feat`) is recorded as (host time after the
    call, token ids, features): what the similarity stage of the check
    starts from.  The records hold the tensors the call made; nothing is
    copied in the window."""
    from neighborretr_tpu_torch.models.neighborretr import NeighborRetr
    orig = NeighborRetr.get_text_feat
    calls = []

    def get_text_feat(self, text_ids, *args, **kwargs):
        out = orig(self, text_ids, *args, **kwargs)
        calls.append((time.perf_counter(), text_ids, out))
        return out

    NeighborRetr.get_text_feat = get_text_feat
    try:
        yield calls
    finally:
        NeighborRetr.get_text_feat = orig


def served_features(judged, queries, encoded, max_words):
    """For each judged request, the text features of its query from the
    tower call that served it (a call between its submit and its reply
    whose ids hold the query's tokens, by the reference's tokenizer), on
    the host; None where no such call was recorded."""
    tok = Tokenizer()
    host = [(tc, ids.cpu().numpy(), out) for tc, ids, out in encoded]
    rows = []
    for ts, tr, _, q in judged:
        want = tok.caption(queries[q], max_words)[0]
        row = None
        for tc, ids, out in host:
            if ts <= tc <= tr and ids.shape[1] == len(want):
                hit = np.flatnonzero((ids == want[None]).all(axis=1))
                if hit.size:
                    row = out[int(hit[0])].float().cpu()
                    break
        rows.append(row)
    return rows


def _sample(done, queries, t, seed):
    """The judged requests: the answered ones with the `judge_longest`
    longest queries, and `judge` more drawn from the seed."""
    ok = [r for r in done if r[2] is not None]
    by_len = sorted(ok, key=lambda r: -len(queries[r[3]].split()))
    picked = by_len[:t["judge_longest"]]
    rest = by_len[t["judge_longest"]:]
    rng = random.Random(core.derive(seed, "judge"))
    picked += rng.sample(rest, min(t["judge"], len(rest)))
    return picked


def judge(judged, queries, files, rcfg, shapes, seed, device,
          precision, served=None) -> dict:
    """The compared numbers of the judged requests, by the reference in
    `precision`; with `served` (each request's text features as the
    program's tower made them) also `sim_gap`, the program's scores against
    the reference's similarity in float64 of those features and the
    returned videos (the similarity stage alone)."""
    set_float32_exact()
    if not judged:
        return {"score_gap": math.inf, "rank_gap": math.inf,
                "sim_gap": math.inf}
    t = files["traffic"]
    P = port.reference_weights(shapes, seed, device)
    feat, mask = core.generator(files).make_index(
        t, rcfg["model"]["embed_dim"], seed, device)
    feat = feat.float()
    tok = Tokenizer()
    k = t["topk"]
    ids = np.asarray([[int(v[1:]) for v, _ in r[2]] for r in judged])
    got = np.asarray([[s for _, s in r[2]] for r in judged], np.float32)
    qs = [queries[r[3]] for r in judged]
    worst = {"score_gap": 0.0, "rank_gap": 0.0}
    step = 64
    for s in range(0, len(qs), step):
        with torch.no_grad():
            tf, tm = RS.query_features(P, tok, qs[s:s + step], rcfg["model"],
                                       Precision(precision))
            S = RS.scores(P, tf, tm, feat, mask)
        top = torch.topk(S, k, dim=1).values
        n = compare.search_numbers(ids[s:s + step], got[s:s + step], S, top)
        for key in worst:
            worst[key] = max(worst[key], n[key])
    if served is not None:
        worst["sim_gap"] = _sim_gap(P, tok, served, qs, ids, got, feat, mask,
                                    rcfg["model"]["max_words"])
    return worst


def _sim_gap(P, tok, served, qs, ids, got, feat, mask, max_words) -> float:
    """max |program's score - float64 reference's score of the program's
    text features and returned video|; inf when a request's features were
    not observed."""
    missing = [i for i, f in enumerate(served) if f is None]
    if missing:
        core.log(f"sim_gap: the text features of {len(missing)} judged "
                 "requests were not observed")
        return math.inf
    dev = feat.device
    worst = 0.0
    for i, (f, q) in enumerate(zip(served, qs)):
        m = torch.as_tensor(tok.caption(q, max_words)[1], device=dev)
        rows = torch.as_tensor(ids[i], device=dev)
        s = RS.pair_scores(P, f.to(dev), m, feat[rows], mask[rows])
        worst = max(worst, float((torch.as_tensor(got[i], device=dev)
                                  .double() - s).abs().max()))
    return worst
