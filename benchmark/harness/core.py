"""What every run shares: the manifest and the files it names, seeds, the
guard against the JAX package, the device, and the result line."""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import time
from typing import Dict, Iterable, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

# top-level module names no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "neighborretr_tpu")
PROGRAM = "neighborretr_tpu_torch"


class BenchError(RuntimeError):
    """A run that cannot produce a result."""


# ---------------------------------------------------------------- files

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: str = MANIFEST) -> dict:
    if not os.path.exists(path):
        raise BenchError(f"no manifest at {path}")
    return load_json(path)


def named_file(kind: str, name: str, ext: str = ".json") -> str:
    """benchmark/<kind>/<name><ext>, which must exist."""
    path = os.path.join(BENCH_DIR, kind, name + ext)
    if not os.path.exists(path):
        raise BenchError(f"{kind} {name!r}: no file {path}")
    return path


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in the manifest")


def cell_files(man: dict, name: str) -> dict:
    """The cell's workload entry, its configuration, its traffic mix and its
    limits, each found by name."""
    w = workload(man, name)
    cfg_entry = next((c for c in man["configs"] if c["name"] == w["config"]),
                     None)
    if cfg_entry is None:
        raise BenchError(f"workload {name!r} names an unknown config")
    return {"workload": w,
            "config": load_json(os.path.join(ROOT, cfg_entry["file"])),
            "traffic": load_json(named_file("traffic", w["traffic"])),
            "limits": load_json(named_file("limits", name))}


def generator(files: dict):
    """The traffic's generator module, found by the name it gives."""
    import importlib
    return importlib.import_module(
        f"benchmark.generators.{files['traffic']['generator']}")


def metrics_for(man: dict, cell: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") the cell
    reports."""
    return [m for m in man[section]
            if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------- seeds

def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


# ---------------------------------------------------------------- guard

def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def program_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] == PROGRAM)


def check_guard() -> None:
    bad = forbidden_loaded()
    if bad:
        raise BenchError("modules of JAX or the JAX package are loaded: "
                         + ", ".join(bad[:20]))


# --------------------------------------------------------------- device

def process_start_time() -> float:
    """The wall-clock time this process started (Linux), for set-up time
    from process start."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own CUDA kernels build under build/kernels/)."""
    base = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda_cache")


def require_cards(n: int) -> None:
    """Raises unless CUDA is available with at least `n` cards: a
    measurement never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < n:
        raise BenchError(f"the cell asks for {n} cards, "
                         f"{torch.cuda.device_count()} found")


def device_info(count: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


# --------------------------------------------------------------- result

def check(value: float, limit: float) -> dict:
    """One compared number beside its limit (it passes at or below it)."""
    return {"value": value, "limit": limit,
            "ok": bool(math.isfinite(value) and value <= limit)}


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
         device: dict, checks: Dict[str, dict],
         breakdown: Optional[dict] = None) -> None:
    """Each compared number and its limit as the last lines of standard
    error, then the result as the last line of standard output, its
    checks under the key that comes last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    print(json.dumps(out), flush=True)


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)
