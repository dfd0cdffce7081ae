"""What the process-group backends do with two ranks on one card.

    python3 -m neighborretr_tpu_torch.tools.collectives_probe [--out FILE]

Starts two processes, both on cuda:0, twice:
  nccl  one all-reduce over NCCL (which expects one rank per card): prints
        the error each rank gets, or that it passed;
  gloo  the collectives the data group (parallel/mesh.py) calls, on CUDA
        tensors over gloo: broadcast, all_gather, all_reduce SUM and MAX,
        broadcast_object_list, each checked against its expected value,
        and the time of one all-reduce of 151 M fp32 values (ViT-B/32's
        gradient buffer) — with the card's name and power limit.
Each run has a time limit of its own; every process is stopped at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

GRAD_NUMEL = 151_000_000


def _rank(backend: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {"backend": backend, "rank": rank}
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out["all_reduce_sum"] = t.tolist()
        if backend == "gloo":
            b = torch.full((3,), float(rank), device=dev)
            dist.broadcast(b, src=0)
            out["broadcast"] = b.tolist()
            parts = [torch.empty(2, device=dev) for _ in range(2)]
            dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
            out["all_gather"] = torch.cat(parts).tolist()
            m = torch.tensor([rank], device=dev)
            dist.all_reduce(m, op=dist.ReduceOp.MAX)
            out["all_reduce_max"] = m.tolist()
            box = [{"from": rank}]
            dist.broadcast_object_list(box, src=0, device=dev)
            out["broadcast_object"] = box[0]
            big = torch.ones(GRAD_NUMEL, device=dev)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(big)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out["big_all_reduce_s"] = times
            out["big_all_reduce_ok"] = bool((big == 8.0).all())
        dist.destroy_process_group()
        out["ok"] = True
    except Exception as e:          # the probe reports what each rank saw
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
    print("PROBE " + json.dumps(out), flush=True)


def _run(backend: str, timeout: float):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "neighborretr_tpu_torch.tools.collectives_probe",
         "--rank", backend, str(r), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    results = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                                1))
        except subprocess.TimeoutExpired:
            text = None
        if text is None:
            results.append({"backend": backend, "ok": False,
                            "error": f"no result within {timeout:.0f} s"})
            continue
        lines = [ln for ln in text.splitlines() if ln.startswith("PROBE ")]
        results.append(json.loads(lines[-1][6:]) if lines else
                       {"backend": backend, "ok": False,
                        "error": "exit " + str(p.returncode) + ": "
                        + text[-1500:]})
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", nargs=3, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        backend, rank, port = args.rank
        return _rank(backend, int(rank), int(port))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    record = {"card": card, "runs": {}}
    for backend, timeout in (("nccl", 120), ("gloo", 300)):
        res = _run(backend, timeout)
        record["runs"][backend] = res
        for r in res:
            print(json.dumps(r))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
