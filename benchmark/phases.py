#!/usr/bin/env python3
"""The program's own spans in one traced run of a cell:

    python3 benchmark/phases.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout.  It runs the cell as `benchmark/run.py
--trace 1` does, result line included, and then logs to standard error the
table of the window's `nr::` spans (`harness/spans.py`): device time by
phase, a train step's or a Searcher call's, the token-weight MLPs' device
time, idle stretches charged to spans, host time by span, and the
dispatcher's mean queue wait (its `queue_wait_s` over its `requests`,
grown while the window's span is open).  A diagnostic beside the
benchmark: none of these numbers is a metric of the result line.  Exits
as `run.py` does.
"""

import contextlib
import os
import sys
from typing import List, Optional, Sequence, Tuple


def queue_lines(deltas: Sequence[Tuple[Optional[float], int]]) -> List[str]:
    """The dispatchers' growth of (queue_wait_s, requests) over the window
    as log lines; a dispatcher with no such counter reads None."""
    out = []
    for wait, n in deltas:
        if wait is None:
            out.append("dispatch: the program keeps no queue-wait counter")
        elif n:
            out.append(f"dispatch: {n} requests, queue wait "
                       f"{1e3 * wait / n:.3f} ms a request")
        else:
            out.append("dispatch: no request served in the window")
    return out


def main(argv) -> int:
    from benchmark.harness import cli, core, spans, trace
    core.cache_dirs()
    from neighborretr_tpu_torch import serving

    seen = {"events": [], "deltas": []}
    dispatchers = []

    class Dispatcher(serving.BatchingDispatcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            dispatchers.append(self)

    def counters():
        return [(getattr(d, "queue_wait_s", None), d.requests)
                for d in dispatchers]

    orig_reduce, orig_window = trace.reduce, trace.window_span
    orig_dispatcher = serving.BatchingDispatcher

    def reduce(events, *args, **kwargs):
        seen["events"] = events
        return orig_reduce(events, *args, **kwargs)

    @contextlib.contextmanager
    def window_span():
        with orig_window():
            before = counters()
            yield
            seen["deltas"] = [
                (None if w0 is None else w1 - w0, n1 - n0)
                for (w0, n0), (w1, n1) in zip(before, counters())]

    trace.reduce, trace.window_span = reduce, window_span
    serving.BatchingDispatcher = Dispatcher
    try:
        rc = cli.main(list(argv) + ["--trace", "1"])
    finally:
        trace.reduce, trace.window_span = orig_reduce, orig_window
        serving.BatchingDispatcher = orig_dispatcher
    if seen["events"]:
        s = (spans.reduce(seen["events"], spans.STEP)
             or spans.reduce(seen["events"], spans.SEARCH))
        for line in spans.table(s) + queue_lines(seen["deltas"]):
            core.log(line)
    return rc


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    sys.exit(main(sys.argv[1:]))
