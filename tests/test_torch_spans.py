"""The port's `nr::` spans (utils/spans.py) and the dispatcher's queue-wait
counter, on the CPU with tiny towers: the spans a profile records around
a train step, a bank fill and a Searcher call; the gate that keeps an
unprofiled run from building a `record_function`; the counter's growth
over requests held in the queue by a slow fake searcher."""

import dataclasses as dc
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neighborretr_tpu_torch import serving
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.data.datasets.synthetic import make_synthetic_batch
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.train import memory_bank as tmb
from neighborretr_tpu_torch.train import step as tstep
from neighborretr_tpu_torch.utils import spans

from test_torch_serve import CountingSearcher
from test_torch_serving import StubTokenizer

B = 8
PHASES = ["nr::step.towers", "nr::step.losses", "nr::step.backward",
          "nr::step.update"]


def _cfg():
    model = dc.replace(tc.ModelConfig.tiny(max_words=8, max_frames=4),
                       cluster_noise=False)
    return tc.Config(model=model, loss=tc.LossConfig(num_neighbors=3),
                     data=tc.DataConfig(max_words=8, max_frames=4),
                     train=tc.TrainConfig(batch_size=B, mb_batch=1))


def _spans_of(prof):
    """The profile's nr:: spans as (name, start, end), by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("nr::")]
    return sorted(out, key=lambda s: s[1])


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    model = W.init_model(cfg.model, 0)
    m = cfg.model
    batch = tstep.to_device(make_synthetic_batch(m, B, seed=3), "cpu")
    bank = tmb.create(cfg.train.memory_bank_capacity, m.max_words,
                      m.max_frames, m.width)
    return cfg, model, batch, bank


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_and_bank_fill_spans(tiny, micro):
    """One train_step records `nr::step` and its four phases inside it, in
    order: towers, losses, backward (the backward, then the gradients'
    reduce), update; under GradCache (`micro_batches=2`) the towers' and
    the losses' spans nest inside the backward's, which holds the second
    pass.  A bank fill batch is set-up and opens no span of its own."""
    cfg, model, batch, bank = tiny
    cfg = dc.replace(cfg, train=dc.replace(cfg.train, micro_batches=micro))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bank = tstep.fill_bank_step(model, bank, batch, cfg, 0)
        state = tstep.create_train_state(model, bank)
        tstep.train_step(state, batch, cfg, 10)
    got = _spans_of(prof)
    names = [n for n, _, _ in got]
    assert names.count("nr::step") == 1
    _, s0, s1 = next(s for s in got if s[0] == "nr::step")
    assert all(s0 <= a for n, a, _ in got if n != "nr::token_weights")
    phases = [s for s in got if s[0].startswith("nr::step.")]
    seq = [n for n, _, _ in phases]
    runs = [n for i, n in enumerate(seq) if i == 0 or n != seq[i - 1]]
    assert runs == (PHASES if micro == 1 else
                    [PHASES[2], PHASES[0], PHASES[1], PHASES[2], PHASES[3]])
    assert all(s0 <= a <= b <= s1 for _, a, b in phases)
    if micro > 1:
        _, b0, b1 = phases[0]
        inner = phases[1:3]
        assert all(b0 <= a <= b <= b1 for _, a, b in inner)
        phases = [phases[0]] + phases[3:]
    assert all(p[2] <= q[1] for p, q in zip(phases, phases[1:]))
    # the token-weight MLPs of the losses' similarities, inside them
    losses = [(a, b) for n, a, b in got if n == PHASES[1]]
    weights = [s for s in got if s[0] == "nr::token_weights"]
    inside = [s for s in weights if s[1] >= s0]
    assert inside and all(any(l0 <= a <= b <= l1 for l0, l1 in losses)
                          for _, a, b in inside)


def test_searcher_spans_once_a_call(tiny):
    cfg, model, _, _ = tiny
    m = cfg.model
    rng = np.random.default_rng(0)
    n = 12
    index = {"video_ids": np.asarray([f"v{i}" for i in range(n)]),
             "v_feat": rng.standard_normal(
                 (n, m.max_frames, m.clip.embed_dim)).astype(np.float16),
             "v_mask": np.ones((n, m.max_frames), np.float32),
             "meta": np.frombuffer(serving.json.dumps(
                 serving._config_meta(cfg, model)).encode(), np.uint8)}
    searcher = serving.Searcher(model, cfg, index, StubTokenizer(),
                                query_batch=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            assert len(searcher.search(["a cat", "a dog runs"], topk=3)) == 2
    names = [n for n, _, _ in _spans_of(prof)]
    for name in ("nr::search", "nr::search.tokenise", "nr::search.text",
                 "nr::search.similarity", "nr::search.topk"):
        assert names.count(name) == 2, (name, names)
    assert names.count("nr::token_weights") == 2


def test_span_off_is_the_shared_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profile")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not spans.recording()
    off = spans.span("nr::step")
    assert off is spans.span("nr::search") is spans._OFF
    with off:
        pass


def test_spans_of_a_thread_started_before_the_profile():
    """The dispatcher's thread runs before a profile starts; a profile of
    every thread (the benchmark's) records its spans, while the thread-
    local profiler flag reads false there."""
    from torch._C._profiler import _ExperimentalConfig
    go, done, seen = threading.Event(), threading.Event(), []

    def worker():
        go.wait()
        seen.append(spans.recording())
        with spans.span("nr::dispatch.merge"):
            pass
        done.set()

    th = threading.Thread(target=worker)
    th.start()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        go.set()
        assert done.wait(30)
    th.join()
    assert seen == [True]
    assert [n for n, _, _ in _spans_of(prof)] == ["nr::dispatch.merge"]


def test_dispatcher_queue_wait_counter():
    """Requests queued behind a call the fake device holds add their wait,
    from submit to the hand-off of their batch, to `queue_wait_s`;
    `requests` counts them."""
    s = CountingSearcher()
    held = threading.Event()
    search = s.search

    def holding(queries, topk=5):
        held.set()
        return search(queries, topk)

    s.search = holding
    d = serving.BatchingDispatcher(s, max_wait_ms=0.0)
    s._gate.clear()
    sent = {}

    def client(i):
        sent[i] = time.perf_counter()
        d.submit([f"q{i}"], 2)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    try:
        assert d.queue_wait_s == 0.0
        threads[0].start()
        assert held.wait(30)             # q0's call is held on the device
        for th in threads[1:]:
            th.start()
        deadline = time.monotonic() + 30
        while d._queue.qsize() < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        queued = time.perf_counter()     # q1-q4 all submitted by now
        time.sleep(0.2)
        released = time.perf_counter()
        s._gate.set()
        for th in threads:
            th.join(timeout=30)
        done = time.perf_counter()
        assert d.requests == 5
        first = d.queue_wait_s
        assert 4 * (released - queued) <= first
        assert first <= sum(done - t for t in sent.values())
        d.submit(["one more"], 1)
        assert d.requests == 6 and d.queue_wait_s > first
    finally:
        s._gate.set()
        d.close()
