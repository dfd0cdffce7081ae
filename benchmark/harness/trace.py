"""The traced run: spans around the program's kernel entries, the profile
of the window, and what the per-layer metrics read from it.

Spans.  Every hand-written kernel of the program is launched through one C
entry that `ops/_build.py::function` hands out.  While a run is traced, the
benchmark wraps that function so that each call of an entry runs inside a
`torch.profiler.record_function` span named

    bench::k|<library>:<entry>|<its integer arguments>|<its None arguments>

and the device operations it launches are attributed to it.  The window
itself is the span `bench::window`.

The profile records the card's activity (kernels, copies, the CUDA
runtime's calls) and, on the host, the user scope alone: these spans, not
every aten op (`profiled`), which keeps the traced step close to the
untraced one.  An idle stretch is named by the runtime call the host was
in, or as time between CUDA calls (Python and torch's dispatch).

The profile is reduced to plain records (`Event`), so that the arithmetic
of `reduce` can be checked on a canned profile without a card.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

KERNEL_SPAN = "bench::k|"
WINDOW_SPAN = "bench::window"
LAUNCH_WORDS = ("LaunchKernel", "launchKernel", "LaunchCooperative")


@dataclasses.dataclass
class Event:
    name: str
    device: bool          # ran on the card (kernel, copy, set)
    start: int            # ns
    dur: int              # ns
    corr: int = 0         # correlation id (a launch and its kernel share it)
    linked: int = 0       # a device event's launching op's correlation id
    tid: int = 0          # host thread

    @property
    def end(self) -> int:
        return self.start + self.dur


@dataclasses.dataclass
class Call:
    key: str              # library:entry
    ints: Tuple[int, ...]
    nulls: Tuple[int, ...]
    device_s: float


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    calls: List[Call]
    other_device_s: float                  # device time outside any entry
    device_ops: List[Tuple[str, float]]    # by total time, descending
    idle_gaps: List[Tuple[str, float]]     # by total time, descending


class _Traced:
    """An entry of the program's kernel libraries, called inside a span."""

    def __init__(self, fn, key: str):
        self._fn, self._key = fn, key

    def __call__(self, *args):
        from torch.profiler import record_function
        ints = ",".join(str(a) for a in args if type(a) is int)
        nulls = ",".join(str(i) for i, a in enumerate(args) if a is None)
        with record_function(f"{KERNEL_SPAN}{self._key}|{ints}|{nulls}"):
            return self._fn(*args)


@contextlib.contextmanager
def kernel_spans():
    """While active, every kernel entry the program fetches from
    `ops/_build.py::function` runs inside its span."""
    from neighborretr_tpu_torch.ops import _build
    orig = _build.function

    def function(lib, name, *args, **kwargs):
        return _Traced(orig(lib, name, *args, **kwargs), f"{lib}:{name}")

    _build.function = function
    try:
        yield
    finally:
        _build.function = orig


def events_of(prof) -> List[Event]:
    """The profile's events as plain records.  The device timeline's copies
    of host spans (user annotations) are left out: no work ran in them."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != DeviceType.CPU
        if on_device and (getattr(e, "is_user_annotation", bool)()
                          or e.name().startswith("bench::")):
            continue
        out.append(Event(name=e.name(),
                         device=on_device,
                         start=int(e.start_ns()), dur=int(e.duration_ns()),
                         corr=int(e.correlation_id()),
                         linked=int(e.linked_correlation_id()),
                         tid=int(e.start_thread_id())))
    return out


def _union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _parse_span(name: str) -> Tuple[str, Tuple[int, ...], Tuple[int, ...]]:
    key, ints, nulls = name[len(KERNEL_SPAN):].split("|")
    def nums(s):
        return tuple(int(x) for x in s.split(",") if x)
    return key, nums(ints), nums(nulls)


def short_name(name: str, width: int = 96) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name if len(name) <= width else name[:width - 3] + "..."


def reduce(events: Sequence[Event], top: int = 10) -> Optional[Reduced]:
    """What the metrics read from a traced window; None when the profile
    holds no window span or no device operation inside it."""
    windows = [e for e in events if not e.device and e.name == WINDOW_SPAN]
    if not windows:
        return None
    w0, w1 = windows[0].start, windows[0].end
    dev = [e for e in events if e.device and e.end > w0 and e.start < w1
           and not e.name.startswith("bench::")]
    if not dev:
        return None
    host = [e for e in events if not e.device]
    # launches carry the runtime's correlation ids, ops the profiler's own
    launches = {e.corr: e for e in host
                if e.corr and any(w in e.name for w in LAUNCH_WORDS)}
    ops_by_corr = {e.corr: e for e in host if e.corr
                   and e.name.startswith(KERNEL_SPAN)}
    spans_by_tid: Dict[int, List[Event]] = {}
    for e in host:
        if e.name.startswith(KERNEL_SPAN):
            spans_by_tid.setdefault(e.tid, []).append(e)
    for spans in spans_by_tid.values():
        spans.sort(key=lambda s: s.start)
    starts = {t: [s.start for s in v] for t, v in spans_by_tid.items()}

    every = sorted((s for v in spans_by_tid.values() for s in v),
                   key=lambda s: s.start)
    every_starts = [s.start for s in every]

    def span_at(tid: int, t: int) -> Optional[Event]:
        """The entry span running at `t` on thread `tid`, else on any
        thread (the profiler may number a thread's spans and its runtime
        calls differently); entry spans hold one C call each."""
        i = bisect.bisect_right(starts.get(tid, []), t) - 1
        if i >= 0 and spans_by_tid[tid][i].end >= t:
            return spans_by_tid[tid][i]
        i = bisect.bisect_right(every_starts, t)
        inside = [s for s in every[max(0, i - 16):i] if s.end >= t]
        return min(inside, key=lambda s: s.dur) if inside else None

    def owner(d: Event) -> Optional[Event]:
        launch = launches.get(d.corr)
        if launch is not None:
            span = span_at(launch.tid, launch.start)
            if span is not None:
                return span
        return ops_by_corr.get(d.linked)

    per_span: Dict[int, float] = {}
    span_of: Dict[int, Event] = {}
    totals: Dict[str, float] = {}
    other = 0.0
    for d in dev:
        s = owner(d)
        secs = (min(d.end, w1) - max(d.start, w0)) / 1e9
        name = short_name(d.name)
        if s is None:
            other += secs
        else:
            per_span[id(s)] = per_span.get(id(s), 0.0) + secs
            span_of[id(s)] = s
            name = f"{_parse_span(s.name)[0].split(':')[1]}: {name}"
        totals[name] = totals.get(name, 0.0) + secs
    calls = []
    for k, secs in per_span.items():
        key, ints, nulls = _parse_span(span_of[k].name)
        calls.append(Call(key, ints, nulls, secs))

    busy = _union([(max(d.start, w0), min(d.end, w1)) for d in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    ops = sorted((e for e in host if not e.name.startswith("bench::")
                  and not any(w in e.name for w in LAUNCH_WORDS)),
                 key=lambda e: e.start)
    op_starts = [e.start for e in ops]
    gap_totals: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(op_starts, mid)
        inner = None
        for e in reversed(ops[max(0, i - 64):i]):
            if e.end >= mid and (inner is None or e.dur < inner.dur):
                inner = e
        label = ("host: " + short_name(inner.name, 80) if inner is not None
                 else "host: between CUDA calls")
        gap_totals[label] = gap_totals.get(label, 0.0) + (b - a) / 1e9

    def ranked(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:top]

    return Reduced(window_s=(w1 - w0) / 1e9, busy_s=busy_s, calls=calls,
                   other_device_s=other, device_ops=ranked(totals),
                   idle_gaps=ranked(gap_totals))


@contextlib.contextmanager
def window_span():
    from torch.profiler import record_function
    with record_function(WINDOW_SPAN):
        yield


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a holder whose `.events` are the profile's records once the
    block is left (empty when not enabled)."""
    holder = dataclasses.make_dataclass("Profile", [("events", list)])([])
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    try:         # host spans of every thread (the dispatcher's too)
        from torch._C._profiler import _ExperimentalConfig
        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        config = None
    with kernel_spans():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       experimental_config=config)
        with _user_scope_only():
            prof.start()
        try:
            yield holder
        finally:
            prof.stop()
    holder.events = events_of(prof)


@contextlib.contextmanager
def _user_scope_only():
    """While the profiler starts, host ops are recorded for the user scope
    alone (`record_function` spans), not for every aten op of every
    thread."""
    import torch.autograd.profiler as AP
    from torch._C._profiler import RecordScope
    orig = AP._enable_profiler

    def enable(config, activities, scopes=None):
        return orig(config, activities, {RecordScope.USER_SCOPE})

    AP._enable_profiler = enable
    try:
        yield
    finally:
        AP._enable_profiler = orig
