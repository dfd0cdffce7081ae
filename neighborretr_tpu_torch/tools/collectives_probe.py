"""What the process-group backends do with two ranks on one card.

    python3 -m neighborretr_tpu_torch.tools.collectives_probe [--out FILE]

Starts two processes, both on cuda:0, twice:
  nccl  one all-reduce over NCCL (which expects one rank per card): prints
        the error each rank gets, or that it passed;
  gloo  the collectives the mesh (parallel/mesh.py) and the sharded
        strategies call, on CUDA tensors over gloo: broadcast, all_gather,
        all_reduce SUM and MAX, broadcast_object_list, all_gather_into_tensor,
        reduce_scatter_tensor, an all-reduce over a subgroup, one FSDP2
        (`fully_shard`) step on a two-layer module over a gloo device mesh,
        batch_isend_irecv around the ring on CPU tensors, then (last: a
        crash there ends the rank) on CUDA tensors; each checked against
        its expected value (or the error it raised).  DTensor's `full_tensor` is left out: over gloo on CUDA
        tensors it ends the process (seen with torch 2.11).  And the time
        of one all-reduce of 151 M fp32 values (ViT-B/32's gradient
        buffer) — with the card's name and power limit.
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
    import faulthandler

    import torch
    faulthandler.enable()
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {"backend": backend, "rank": rank, "torch": torch.__version__}
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
            del big
            out.update(_sharding_collectives(dist, torch, dev, rank, out))
        dist.destroy_process_group()
        out["ok"] = True
    except Exception as e:          # the probe reports what each rank saw
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
    print("PROBE " + json.dumps(out), flush=True)


def _attempt(fn):
    """fn()'s value, or the error it raised: the probe records what each
    collective does on this backend."""
    try:
        return fn()
    except Exception as e:
        return f"error {type(e).__name__}: {str(e)[:300]}"


def _sharding_collectives(dist, torch, dev, rank: int, out: dict) -> dict:
    """The collectives of the sharded strategies (FSDP2, the pipeline's
    ring, the tensor-parallel subgroups) on CUDA tensors, two ranks; each
    result is added to `out` and printed as it comes."""
    x = torch.arange(4., device=dev) + rank

    def agit():
        o = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(o, x)
        return o.tolist()

    def rst():
        o = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(o, x.clone())
        return o.tolist()

    def p2p(on):
        def run():
            src, r = x.to(on), torch.empty(4, device=on)
            ops = [dist.P2POp(dist.isend, src, (rank + 1) % 2),
                   dist.P2POp(dist.irecv, r, (rank + 1) % 2)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return r.tolist()
        return run

    def subgroup():
        mine, _ = dist.new_subgroups_by_enumeration([[0, 1]])
        t = torch.full((2,), float(rank + 1), device=dev)
        dist.all_reduce(t, group=mine)
        return t.tolist()

    def fsdp2():
        """One FSDP2 step over gloo."""
        def run():
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.fsdp import fully_shard
            torch.manual_seed(0)
            m = torch.nn.Sequential(torch.nn.Linear(8, 6),
                                    torch.nn.Linear(6, 4)).to(dev)
            ref = sum(p.sum().item() for p in m.parameters())
            dm = DeviceMesh.from_group(dist.new_group([0, 1]), "cuda")
            for layer in list(m) + [m]:
                fully_shard(layer, mesh=dm)
            m(torch.ones(2, 8, device=dev)).sum().backward()

            def total(ts):       # not DTensor.full_tensor: see the docstring
                t = torch.stack([x.to_local().sum() for x in ts])
                dist.all_reduce(t)
                return t.tolist()

            return {"params_equal": abs(sum(total(m.parameters())) - ref)
                    < 1e-5,
                    "grad_sums": total([p.grad for p in m.parameters()])}
        return run

    # the ring on CUDA tensors last: over gloo it aborts the process (a
    # write from a device pointer), so every earlier result is printed
    # before it runs
    for name, fn in (("all_gather_into_tensor", agit),
                     ("reduce_scatter_tensor", rst),
                     ("subgroup_all_reduce", subgroup),
                     ("fsdp2", fsdp2()),
                     ("batch_isend_irecv_host", p2p("cpu")),
                     ("batch_isend_irecv_cuda", p2p(dev))):
        out[name] = _attempt(fn)
        torch.cuda.synchronize()
        print("PROBE " + json.dumps(out), flush=True)
    return out


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
        res = json.loads(lines[-1][6:]) if lines else {"backend": backend}
        if "ok" not in res:         # the rank died before its last line
            res.update(ok=False, error=f"exit {p.returncode}: "
                       + "\n".join(ln for ln in text.splitlines()
                                    if not ln.startswith("PROBE "))[-1500:])
        results.append(res)
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
