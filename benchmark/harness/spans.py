"""The program's own spans in a traced window (`nr::`, the program's
utils/spans.py): device time by phase, the token-weight MLPs' device time,
host time by span, and the window's idle stretches charged to spans.

A root span is one train step (`nr::step`) or one Searcher call
(`nr::search`); its phases are the spans named `<root>.<phase>` on the
root's thread.  A device operation counts for the innermost phase open, at
its launch (the CUDA runtime call that shares its correlation id), on the
thread of the root open then.  So launches from another thread while a
phase is open (autograd's worker thread in the backward, a remat's
recomputed forward there) count for that phase, and a launch inside a
`bench::k|` entry span counts for the phase around the entry.  Where the
runtime call was not recorded, the launch time is the start of the
innermost user-scope span open on the launching thread (the device
operation's linked correlation id, where the profile sets one).

An idle stretch of the window (no device operation running) is charged to
the innermost `nr::` span open at its midpoint on the thread that launched
the first device operation after it, or, where that thread is unknown or
has none open (autograd's worker), on any thread; else to "outside the
program's spans".  The launching thread is known only through a linked
correlation id: the runtime's calls number host threads apart from the
spans (on an H100 under torch 2.11 every runtime call read thread 1 and
every linked id 0), so there the span is taken from any thread; in each
cell one thread opens every `nr::` span.

Pure functions over `trace.Event` records, checked on a canned profile;
`benchmark/phases.py` prints the table of one traced run of a cell."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace
from .trace import Event

PREFIX = "nr::"
STEP = "nr::step"
SEARCH = "nr::search"
TOKEN_WEIGHTS = "nr::token_weights"
# the runtime calls that put a device operation on a stream: trace.py's
# kernel launches, and the copies and sets
RUNTIME_WORDS = trace.LAUNCH_WORDS + ("Memcpy", "Memset")
USER = (PREFIX, "bench::")        # the profile's user-scope spans
OUTSIDE = "outside the program's spans"
_BACK = 64          # spans looked back at for one that holds a time


@dataclasses.dataclass
class Spans:
    root: str
    roots: int                         # root spans started in the window
    device_s: float                    # device seconds in the window
    phase_s: Dict[str, float]          # by phase; "" = in a root, no phase
    outside_root_s: float              # launched outside every root
    token_weights_s: float             # launched inside any token_weights
    opened: List[str]                  # nr:: span names seen in the window
    host_s: Dict[str, float]           # host seconds by nr:: span name
    idle: List[Tuple[str, float]]      # idle seconds by span, descending


class _Intervals:
    """Spans sorted by start; `at(t)` is the innermost one holding t
    (spans of one thread nest, so the latest started that still runs)."""

    def __init__(self, spans: Sequence[Event]):
        self.spans = sorted(spans, key=lambda s: s.start)
        self.starts = [s.start for s in self.spans]

    def at(self, t: int) -> Optional[Event]:
        i = bisect.bisect_right(self.starts, t)
        for s in reversed(self.spans[max(0, i - _BACK):i]):
            if s.end >= t:
                return s
        return None


def reduce(events: Sequence[Event], root: str) -> Optional[Spans]:
    """The window's spans under `root`; None when the window holds no root
    span or no device operation (a program without these spans)."""
    windows = [e for e in events
               if not e.device and e.name == trace.WINDOW_SPAN]
    if not windows:
        return None
    w0, w1 = windows[0].start, windows[0].end
    host = [e for e in events if not e.device]
    mine = [e for e in host if e.name.startswith(PREFIX)
            and e.end > w0 and e.start < w1]
    roots = [e for e in mine if e.name == root]
    dev = [e for e in events if e.device and e.end > w0 and e.start < w1
           and not e.name.startswith("bench::")]
    if not roots or not dev:
        return None
    # CUDA runtime calls carry the runtime's correlation ids, user-scope
    # spans the profiler's own: kept apart, as the two may coincide
    runtime = {e.corr: e for e in host if e.corr
               and any(w in e.name for w in RUNTIME_WORDS)}
    user = {e.corr: e for e in host if e.corr and e.name.startswith(USER)}
    root_iv = _Intervals(roots)
    phase_iv = {t: _Intervals([e for e in mine if e.tid == t
                               and e.name.startswith(root + ".")])
                for t in {r.tid for r in roots}}
    weights_iv = _Intervals([e for e in mine if e.name == TOKEN_WEIGHTS])
    by_tid: Dict[int, List[Event]] = {}
    for e in mine:
        by_tid.setdefault(e.tid, []).append(e)
    mine_iv = {t: _Intervals(v) for t, v in by_tid.items()}
    any_iv = _Intervals(mine)

    def launch(d: Event) -> Tuple[Optional[int], Optional[int]]:
        """(launch time, the launching thread's span numbering)."""
        u = user.get(d.linked) if d.linked else None
        r = runtime.get(d.corr)
        t = r.start if r is not None else (u.start if u is not None else None)
        return t, (u.tid if u is not None else None)

    def clipped(a: int, b: int) -> float:
        return (min(b, w1) - max(a, w0)) / 1e9

    phase_s: Dict[str, float] = {}
    outside = weights = total = 0.0
    for d in dev:
        secs = clipped(d.start, d.end)
        total += secs
        t, _ = launch(d)
        r = root_iv.at(t) if t is not None else None
        if r is None:
            outside += secs
            continue
        p = phase_iv[r.tid].at(t)
        name = p.name if p is not None and p.start >= r.start else ""
        phase_s[name] = phase_s.get(name, 0.0) + secs
        if weights_iv.at(t) is not None:
            weights += secs

    host_s: Dict[str, float] = {}
    for e in mine:
        host_s[e.name] = host_s.get(e.name, 0.0) + clipped(e.start, e.end)

    busy = trace._union([(max(d.start, w0), min(d.end, w1)) for d in dev])
    first_at = {}
    for d in sorted(dev, key=lambda d: d.start, reverse=True):
        first_at[max(d.start, w0)] = d
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        nxt = first_at.get(b)
        tid = launch(nxt)[1] if nxt is not None else None
        s = mine_iv[tid].at(mid) if tid in mine_iv else None
        s = s if s is not None else any_iv.at(mid)
        label = s.name if s is not None else OUTSIDE
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9

    return Spans(root=root,
                 roots=sum(1 for r in roots if r.start >= w0),
                 device_s=total, phase_s=phase_s, outside_root_s=outside,
                 token_weights_s=weights,
                 opened=sorted({e.name for e in mine}), host_s=host_s,
                 idle=sorted(idle.items(), key=lambda kv: -kv[1]))


def table(s: Optional[Spans]) -> List[str]:
    """The log's lines: device seconds by phase, the token-weight MLPs'
    device seconds, the idle stretches by span, and host seconds by span,
    each also in ms a root span and as a share of the window's device or
    idle time."""
    if s is None:
        return ["spans: the window holds no nr:: root span"]
    out = [f"spans: {s.roots} {s.root} in the window, "
           f"{s.device_s:.4f} device s"]

    def row(kind, name, secs, whole):
        per = f", {1e3 * secs / s.roots:.3f} ms a {s.root}" if s.roots else ""
        share = f" ({100.0 * secs / whole:.2f}%)" if whole else ""
        return f"  {kind} {name}: {secs:.4f} s{per}{share}"

    rows = sorted(s.phase_s.items(), key=lambda kv: -kv[1])
    rows.append((f"outside {s.root}", s.outside_root_s))
    for name, secs in rows:
        out.append(row("device", name or s.root + " (no phase)", secs,
                       s.device_s))
    out.append(row("device", TOKEN_WEIGHTS, s.token_weights_s, s.device_s))
    idle_total = sum(v for _, v in s.idle)
    for name, secs in s.idle:
        out.append(row("idle", name, secs, idle_total))
    for name in sorted(s.host_s):
        out.append(row("host", name, s.host_s[name], 0.0))
    return out
