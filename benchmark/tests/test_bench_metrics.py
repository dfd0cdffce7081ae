"""The trace's reduction and every per-layer reader on a canned profile."""

import pytest

from benchmark.counts import kernels as K
from benchmark.counts import peaks
from benchmark.harness import core, readers, trace
from benchmark.harness.trace import Event

MS = 1_000_000   # ns


def canned():
    """A window of 100 ms on one host thread (tid 1): a K1 entry span whose
    launch (runtime correlation 7) runs a 4 ms kernel, a K2 entry span
    linked by the profiler's own correlation (op 50) to a 6 ms kernel, a
    K9 entry span on thread 2 whose launch the runtime files under thread 1
    (a 1 ms kernel), two torch kernels of 10 and 5 ms, one overlapping the
    first; the host in aten::item during the last idle stretch."""
    k1 = f"{trace.KERNEL_SPAN}ln_attention_residual:ln_attention_residual_fwd|1536,50,768,12|1"
    k2 = f"{trace.KERNEL_SPAN}interaction_similarity:interaction_similarity_fwd|64,10000,24,12,512|5,6,7,8"
    k9 = f"{trace.KERNEL_SPAN}frame_attention:frame_attention_bwd|192,197,768,12|1"
    return [
        Event(trace.WINDOW_SPAN, False, 0, 100 * MS, tid=1),
        Event(k1, False, 10 * MS, 1 * MS, corr=40, tid=1),
        Event("cudaLaunchKernel", False, 10 * MS + 100, 1000, corr=7, tid=1),
        Event("void (anonymous namespace)::gemm_kernel<3>", True, 12 * MS,
              4 * MS, corr=7),
        Event(k2, False, 30 * MS, 1 * MS, corr=50, tid=1),
        Event("similarity_kernel", True, 31 * MS, 6 * MS, corr=99,
              linked=50),
        Event(k9, False, 38 * MS, 1 * MS, corr=70, tid=2),
        Event("cudaLaunchKernel", False, 38 * MS + 500, 1000, corr=8, tid=1),
        Event("bwd_dq_kernel", True, 38 * MS + 700, 1 * MS, corr=8),
        Event("ampere_sgemm", True, 40 * MS, 10 * MS, corr=101),
        Event("elementwise", True, 45 * MS, 5 * MS, corr=102),
        Event("aten::item", False, 60 * MS, 40 * MS, corr=60, tid=1),
        Event("outside", True, 150 * MS, 5 * MS, corr=103),
    ]


def test_reduce_attributes_busy_and_gaps():
    r = trace.reduce(canned())
    assert r.window_s == pytest.approx(0.1)
    assert r.busy_s == pytest.approx(0.021)
    assert r.other_device_s == pytest.approx(0.015)
    calls = {c.key: c for c in r.calls}
    k1 = calls["ln_attention_residual:ln_attention_residual_fwd"]
    assert k1.ints == (1536, 50, 768, 12) and k1.nulls == (1,)
    assert k1.device_s == pytest.approx(0.004)
    k2 = calls["interaction_similarity:interaction_similarity_fwd"]
    assert k2.device_s == pytest.approx(0.006) and k2.nulls == (5, 6, 7, 8)
    assert r.device_ops[0] == ("ampere_sgemm", pytest.approx(0.010))
    assert ("ln_attention_residual_fwd: gemm_kernel<3>",
            pytest.approx(0.004)) in r.device_ops
    gaps = dict(r.idle_gaps)
    assert gaps["host: aten::item"] == pytest.approx(0.050)
    assert sum(gaps.values()) == pytest.approx(0.079)
    k9 = calls["frame_attention:frame_attention_bwd"]
    assert k9.device_s == pytest.approx(0.001)


def test_reduce_finds_nothing_without_window_or_device_work():
    ev = canned()
    assert trace.reduce(ev[1:]) is None
    assert trace.reduce([e for e in ev if not e.device]) is None


def _ctx(**kw):
    ctx = {"trace": trace.reduce(canned()),
           "kernels": readers.kernel_entries(), "units": 10,
           "window_s": 0.1}
    ctx.update(kw)
    return ctx


def test_readers_on_the_canned_profile():
    train = _ctx(step_flops=1e12)
    search = _ctx(calls=4)
    k1 = K.bound_s("K1", dict(N=1536, L=50, D=768, H=12),
                   dict(has_bias=False))
    k2 = K.bound_s("K2", dict(A=64, B=10000, T=24, V=12, D=512),
                   dict(saved=False, bf16=False))
    k9 = K.bound_s("K9", dict(N=192, L=197, D=768, H=12),
                   dict(has_bias=False))
    want = {
        ("k8k9.roofline_pct", "t"): 100 * k9 / 0.001,
        ("step.mfu", "t"): 100 * 1e12 * 10 / 0.1 / peaks.BF16,
        ("device.idle_pct.train", "t"): 79.0,
        ("torch_ops.ms_per_step", "t"): 1.5,
        ("k1k3.roofline_pct", "t"): 100 * k1 / 0.004,
        ("device.idle_pct.search", "s"): 79.0,
        ("k2.roofline_pct.search", "s"): 100 * k2 / 0.006,
        ("dispatch.queries_per_call", "s"): 2.5,
    }
    for (name, side), value in want.items():
        ctx = train if side == "t" else search
        assert readers.load(name).read(ctx) == pytest.approx(value)


def test_readers_return_nothing_where_nothing_is_read():
    train = _ctx(step_flops=1e12)
    assert readers.load("dispatch.queries_per_call").read(train) is None
    assert readers.load("k2.roofline_pct.search").read(train) is None
    search = _ctx(calls=4)
    assert readers.load("step.mfu").read(search) is None
    assert readers.load("torch_ops.ms_per_step").read(search) is None


def test_read_all_leaves_silent_metrics_out():
    man = core.manifest()
    ms = core.metrics_for(man, "vitb32.msrvtt_train", "per_layer")
    out = readers.read_all(ms, _ctx(step_flops=1e12))
    assert "k8k9.roofline_pct" not in out
    assert out["k1k3.roofline_pct"]["unit"] == "%"


def test_entry_spans_wrap_the_program_kernels(monkeypatch):
    from neighborretr_tpu_torch.ops import _build
    seen = []

    def fake(lib, name, argtypes, restype=None):
        return lambda *a: seen.append((lib, name, a)) or 0

    monkeypatch.setattr(_build, "function", fake)
    with trace.kernel_spans():
        fn = _build.function("frame_attention", "frame_attention_fwd", [])
        assert isinstance(fn, trace._Traced)
        assert fn(None, None, 3, 4) == 0
    assert _build.function is fake
    assert seen == [("frame_attention", "frame_attention_fwd",
                     (None, None, 3, 4))]


def test_read_all_refuses_a_listed_metric_that_reads_nothing():
    """A listed metric whose reader is not a kernel roofline, or a roofline
    while no entry span saw a launch, reading nothing means the measurement
    failed: no result."""
    man = core.manifest()
    search_ms = core.metrics_for(man, "vitb32.search", "per_layer")
    with pytest.raises(core.BenchError, match="dispatch.queries_per_call"):
        readers.read_all(search_ms, _ctx())            # no `calls` counter
    train_ms = core.metrics_for(man, "vitb16.msrvtt_train", "per_layer")
    ctx = _ctx(step_flops=1e12)
    ctx["trace"].calls = [c for c in ctx["trace"].calls
                          if not c.key.startswith("frame_attention")]
    out = readers.read_all(train_ms, ctx)               # K8/K9 off the path
    assert "k8k9.roofline_pct" not in out and "k1k3.roofline_pct" in out
    ctx["trace"].calls = []
    with pytest.raises(core.BenchError, match="no kernel entry"):
        readers.read_all(train_ms, ctx)


def test_profile_keeps_the_user_scope_only():
    """The traced window records the benchmark's spans and not every aten
    op (CPU activity here; on a card the device's activity besides)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    with trace._user_scope_only():
        prof.start()
    try:
        with trace.window_span():
            torch.randn(8, 8) @ torch.randn(8, 8)
    finally:
        prof.stop()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert trace.WINDOW_SPAN in names
    assert not any(n.startswith("aten::") for n in names), names
