"""The program's spans in a traced window (harness/spans.py) and the
table `benchmark/phases.py` logs from them, on canned profiles."""

import pytest

from benchmark import phases
from benchmark.harness import spans, trace
from benchmark.harness.trace import Event

from benchmark.tests.test_bench_metrics import canned as canned_without_spans

MS = 1_000_000   # ns
SYS = 900        # the runtime's numbering of host threads: never a span's


def _launch(name, at_ms, corr, tid=SYS):
    return Event(name, False, int(at_ms * MS), 1000, corr=corr, tid=tid)


def _op(name, start_ms, end_ms, corr, linked=0):
    return Event(name, True, int(start_ms * MS), int((end_ms - start_ms) * MS),
                 corr=corr, linked=linked)


def _span(name, start_ms, end_ms, corr, tid=1):
    return Event(name, False, int(start_ms * MS),
                 int((end_ms - start_ms) * MS), corr=corr, tid=tid)


def canned_step():
    """A 200 ms window and one train step on thread 1 (the profiler's
    numbering; the runtime's calls carry thread 900).  towers: a 10 ms op
    and, from inside a K1 entry span, a 4 ms op; losses: a 6 ms op inside
    `nr::token_weights`; backward: an 8 ms op launched from autograd's
    worker thread with no span open there, and a remat's recomputed K1
    entry on that thread (thread 3) with a 3 ms op and a 2 ms op whose
    runtime call was not recorded; update: an 8 ms op; 0.5 ms launched
    in the step between phases; 2 ms launched after the step.  Thread 2
    waits on the loader from 115 to 145 ms while thread 1 is in `nr::other`
    (120-140), and thread 2 launches the op after that idle stretch.  The
    user spans' correlation ids (the profiler's) reuse the runtime's."""
    k1 = f"{trace.KERNEL_SPAN}ln_attention_residual:ln_attention_residual_fwd|1536,50,768,12|1"
    k1_remat = f"{trace.KERNEL_SPAN}ln_attention_residual:ln_attention_residual_fwd|1536,50,768,12|1"
    return [
        _span(trace.WINDOW_SPAN, 0, 200, corr=100),
        _span("nr::step", 5, 110, corr=101),
        _span("nr::step.towers", 12, 30, corr=1),
        _launch("cudaLaunchKernel", 13, corr=1),
        _op("towers_gemm", 20, 30, corr=1, linked=1),
        _span(k1, 15, 16, corr=102),
        _launch("cuLaunchKernel", 15.5, corr=2),
        _op("k1_kernel", 30, 34, corr=2, linked=102),
        _span("nr::step.losses", 30, 50, corr=103),
        _span("nr::token_weights", 31, 33, corr=104),
        _launch("cudaLaunchKernel", 32, corr=3),
        _op("weights_gemm", 34, 40, corr=3, linked=104),
        _span("nr::step.backward", 50, 90, corr=105),
        _launch("cudaLaunchKernel", 55, corr=4, tid=SYS + 1),
        _op("autograd_elementwise", 62, 70, corr=4),
        _span(k1_remat, 71, 72, corr=106, tid=3),
        _launch("cuLaunchKernel", 71.5, corr=5, tid=SYS + 1),
        _op("k1_recompute", 72, 75, corr=5, linked=106),
        _op("k3_lost_launch", 75, 77, corr=6, linked=106),
        _span("nr::step.update", 90, 108, corr=107),
        _launch("cudaLaunchKernel", 91, corr=7),
        _op("adam", 92, 100, corr=7, linked=107),
        _launch("cudaLaunchKernel", 109, corr=8),
        _op("between_phases", 109.5, 110, corr=8, linked=101),
        _span("nr::loader.wait", 115, 145, corr=108, tid=2),
        _span("nr::other", 120, 140, corr=109),
        _span("nr::after", 148, 151, corr=110, tid=2),
        _launch("cudaMemcpyAsync", 150, corr=9, tid=SYS + 2),
        _op("Memcpy HtoD", 150, 152, corr=9, linked=110),
    ]


def test_device_time_by_phase():
    s = spans.reduce(canned_step(), spans.STEP)
    assert s.roots == 1
    assert s.device_s == pytest.approx(0.0435)
    got = {k: pytest.approx(v) for k, v in s.phase_s.items()}
    assert got == {"nr::step.towers": 0.014,       # its op and K1's, inside
                   "nr::step.losses": 0.006,
                   "nr::step.backward": 0.013,     # autograd's thread, remat
                   "nr::step.update": 0.008,
                   "": 0.0005}
    assert s.outside_root_s == pytest.approx(0.002)
    assert s.token_weights_s == pytest.approx(0.006)
    assert "nr::loader.wait" in s.opened


def test_idle_stretches_charged_by_the_next_launch_thread():
    idle = dict(spans.reduce(canned_step(), spans.STEP).idle)
    want = {"nr::step": 0.020,                  # 0-20: before the towers' op
            "nr::step.backward": 0.022 + 0.002 + 0.015,
            "nr::step.update": 0.0095,
            "nr::loader.wait": 0.040,           # thread 2 launches next
            spans.OUTSIDE: 0.048}
    assert idle == {k: pytest.approx(v) for k, v in want.items()}


def test_host_time_by_span_and_the_log_table():
    s = spans.reduce(canned_step(), spans.STEP)
    assert s.host_s["nr::step.losses"] == pytest.approx(0.020)
    lines = spans.table(s)
    assert lines[0].startswith("spans: 1 nr::step")
    assert any("idle nr::loader.wait" in x for x in lines)
    # ms a root span beside each row: one step in the window
    assert "  device nr::step.towers: 0.0140 s, 14.000 ms a nr::step " \
        "(32.18%)" in lines
    assert "  host nr::step.losses: 0.0200 s, 20.000 ms a nr::step" in lines
    assert spans.table(None) == ["spans: the window holds no nr:: root span"]


def canned_search():
    """Two Searcher calls on the dispatcher's thread (2): each tokenises
    for 1 ms, spends 0.5 ms in the text tower, then launches a 5 ms
    token-weight op and a 4 ms K2 op; a 1 ms op launched outside any
    call."""
    ev = [_span(trace.WINDOW_SPAN, 0, 100, corr=100)]
    for i, t0 in enumerate((10, 50)):
        c = 10 * (i + 1)
        ev += [_span("nr::search", t0, t0 + 30, corr=200 + c, tid=2),
               _span("nr::search.tokenise", t0, t0 + 1, corr=201 + c, tid=2),
               _span("nr::search.text", t0 + 1, t0 + 1.5, corr=204 + c,
                     tid=2),
               _span("nr::search.similarity", t0 + 2, t0 + 5, corr=202 + c,
                     tid=2),
               _span("nr::token_weights", t0 + 2, t0 + 3, corr=203 + c,
                     tid=2),
               _launch("cudaLaunchKernel", t0 + 2.5, corr=c),
               _op("sgemm", t0 + 3, t0 + 8, corr=c, linked=203 + c),
               _launch("cuLaunchKernel", t0 + 4, corr=c + 1),
               _op("k2", t0 + 8, t0 + 12, corr=c + 1, linked=202 + c)]
    ev += [_launch("cudaLaunchKernel", 95, corr=99),
           _op("stray", 95, 96, corr=99)]
    return ev


def test_search_table():
    s = spans.reduce(canned_search(), spans.SEARCH)
    assert s.roots == 2
    assert s.phase_s["nr::search.similarity"] == pytest.approx(0.018)
    assert s.outside_root_s == pytest.approx(0.001)
    assert s.token_weights_s == pytest.approx(0.010)
    assert s.host_s["nr::search.tokenise"] == pytest.approx(0.002)
    assert s.host_s["nr::search.text"] == pytest.approx(0.001)
    lines = spans.table(s)
    want = ["  device nr::token_weights: 0.0100 s, 5.000 ms a nr::search",
            "  host nr::search.tokenise: 0.0020 s, 1.000 ms a nr::search",
            "  host nr::search.text: 0.0010 s, 0.500 ms a nr::search"]
    for w in want:
        assert any(x.startswith(w) for x in lines), w
    # a search window holds no train step, and back
    assert spans.reduce(canned_search(), spans.STEP) is None
    assert spans.reduce(canned_step(), spans.SEARCH) is None


def test_queue_wait_lines():
    assert phases.queue_lines([(0.25, 100)]) == [
        "dispatch: 100 requests, queue wait 2.500 ms a request"]
    assert phases.queue_lines([(None, 100)]) == [
        "dispatch: the program keeps no queue-wait counter"]
    assert phases.queue_lines([(0.0, 0)]) == [
        "dispatch: no request served in the window"]
    assert phases.queue_lines([]) == []


def test_a_program_without_spans_reads_nothing():
    """A program that opens no nr:: span (the parent of these spans): no
    root in the window, and the table says so."""
    events = canned_without_spans()
    assert spans.reduce(events, spans.STEP) is None
    assert spans.reduce(events, spans.SEARCH) is None
    assert spans.table(None) == ["spans: the window holds no nr:: root span"]


def test_phases_without_a_card_gives_no_table(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = phases.main(["--workload", "vitb32.search", "--seed", "1",
                      "--seconds", "1"])
    cap = capsys.readouterr()
    assert rc != 0 and cap.out.strip() == ""
    assert "no card" in cap.err and "spans:" not in cap.err
    from neighborretr_tpu_torch import serving
    assert serving.BatchingDispatcher.__name__ == "BatchingDispatcher"
    assert trace.reduce.__module__ == "benchmark.harness.trace"
