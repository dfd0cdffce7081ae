"""The entry of a run: arguments, the guard, the card, the cell's driver and
the result line."""

from __future__ import annotations

import argparse
import importlib
import sys
import traceback

from . import core, readers


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def driver(files: dict):
    return importlib.import_module(f"benchmark.kinds.{files['traffic']['driver']}")


def main(argv) -> int:
    t_start = core.process_start_time()
    args = parse(argv)
    try:
        core.cache_dirs()
        man = core.manifest()
        files = core.cell_files(man, args.workload)
        core.require_cards(files["workload"]["chips"])
        core.check_guard()
        out = driver(files).run(files, args.seed, args.seconds,
                                bool(args.trace), "cuda", t_start)
        core.check_guard()
    except core.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except Exception:                    # noqa: BLE001 — no result
        traceback.print_exc()
        return 1
    cell = args.workload
    device = out["device"]
    breakdown = None
    if args.trace:
        r = out["reduced"]
        if r is None:
            print("benchmark: the traced window holds no device operation",
                  file=sys.stderr)
            return 3
        device = dict(device, busy_s=r.busy_s, window_s=r.window_s)
        try:
            metrics = readers.read_all(
                core.metrics_for(man, cell, "per_layer"), out["ctx"])
        except core.BenchError as e:
            print(f"benchmark: {e}", file=sys.stderr)
            return 3
        breakdown = {"device_ops": [[n, s] for n, s in r.device_ops],
                     "idle_gaps": [[n, s] for n, s in r.idle_gaps]}
    else:
        values = driver(files).end_to_end(out)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in core.metrics_for(man, cell, "end_to_end")}
    for k, v in out.get("info", {}).items():
        core.log(f"shown beside the checks: {k} {v!r}")
    core.emit(out["correct"], out["attempted"], out["failed"], metrics,
              device, out["checks"], breakdown)
    return 0
