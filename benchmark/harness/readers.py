"""Per-layer metrics: one reader a metric, `benchmark/metrics/<name>.py`,
found by the metric's name.  A reader's `read(ctx)` returns the number, or
None when the traced run holds nothing for it to read: a kernel roofline
whose kernels a program change took off the path is then left out of the
result line (`read_all`).

ctx: "trace" (trace.Reduced), "kernels" (counts/kernels.json's entries),
"units" (steps or queries completed in the window), "window_s" (the
window's host seconds), "step_flops" (model FLOP of one step, training
only), "calls" (the Searcher's device calls in the window, search only).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, List, Optional

from . import core


def load(name: str):
    path = core.named_file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_entries() -> dict:
    return core.load_json(os.path.join(core.BENCH_DIR, "counts",
                                       "kernels.json"))["entries"]


def read_all(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """The cell's per-layer metrics.  A metric the cell lists may read
    nothing only where its reader says it goes silent when its kernels are
    off the path (`OFF_PATH_SILENT`), and then only while some entry span
    of the window saw a launch; otherwise the measurement itself failed and
    this raises, so the run gives no result."""
    out, silent = {}, []
    for m in metrics:
        mod = load(m["name"])
        value: Optional[float] = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not getattr(mod, "OFF_PATH_SILENT", False):
            silent.append(m["name"])
        elif not ctx["trace"].calls:
            silent.append(m["name"] + " (no kernel entry's span saw a "
                          "launch in the window)")
    if silent:
        raise core.BenchError("per-layer metrics the cell lists read "
                              "nothing: " + ", ".join(silent))
    return out


def roofline(ctx: dict, families) -> Optional[float]:
    """Σ each call's bound ÷ Σ those calls' device time, in %, over the
    traced calls of the kernel families named; None when there are none."""
    from ..counts import kernels as K
    bound = busy = 0.0
    for c in ctx["trace"].calls:
        e = ctx["kernels"].get(c.key)
        if e is None or e["family"] not in families:
            continue
        ints = dict(zip(e["ints"], c.ints))
        flags = {f: pos not in c.nulls for f, pos in e.get("flags", {}).items()}
        flags.update(e.get("const", {}))
        bound += K.bound_s(e["family"], ints, flags)
        busy += c.device_s
    if busy <= 0.0:
        return None
    return 100.0 * bound / busy
