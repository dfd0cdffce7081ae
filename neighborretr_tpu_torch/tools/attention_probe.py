"""Where the time of one K8 / K9 call (frame_attention and its backward)
goes, for two trees of this repository in turns on one card.

    git archive <commit> | tar -x -C build/parent     # the tree to compare
    python3 -m neighborretr_tpu_torch.tools.attention_probe build/parent . \
        [--step] [--out chiprun_out/attention_probe.json]

Each tree runs in a process of its own that imports that tree's package, in
the order A, B, B, A, at the seven shapes of chip_smoke.py's phase 11 (the
same inputs from one seed in every process).  Per kernel and shape:

  call_ms    one wrapper call between two CUDA events, the median of many
             (phase 11's `time_ms`: host and device time, the card idle
             until the call reaches it);
  device_ms  the wrapper called `reps` times behind a sleep kernel that
             holds the stream until every call is queued, over reps: the
             kernels' own time (`queued` says whether the host did queue
             them all within the sleep);
  host_us    wall-clock microseconds per wrapper call over a loop, at the
             N=128 shapes only, where the card keeps up with the host.

At the N=128 shapes it also times the wrapper's host pieces one by one: the
argument checks, each output allocation, the device guard, the stream handle
(torch.cuda.current_stream().cuda_stream, and torch's raw-handle call for
comparison) and the C entry alone on buffers made beforehand.  K9 is called
as each tree's autograd node calls it (with the forward's out and lse where
the wrapper takes them).

--step then runs each tree's chip_smoke.py phase 12b (the fused ViT-B/32
train run, every attention sublayer through K8/K9) in turns A, B, B, A and
prints its ms/step lines.

--sdpa TREE times that tree's K8 and K9 against
`scaled_dot_product_attention` and its backward (phase 11's yardstick, the
same strided views and bf16 mask) in one process, in turns kernel, library,
library, kernel, three rounds, at every shape: device time behind a sleep
and one call between two events, and the ratios of their means.

    python3 -m neighborretr_tpu_torch.tools.attention_probe --sdpa . \
        [--out build/attention_sdpa.json]
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = [("vision", 1536, 50, 12, None),
          ("text", 128, 24, 8, "causal"),
          ("temporal", 128, 12, 8, "keypad"),
          ("text long", 128, 64, 8, "causal"),
          ("temporal long", 128, 64, 8, "keypad"),
          ("vision ViT-B/16", 192, 197, 12, None),
          ("vision ViT-L/14@336px", 192, 577, 16, None)]
SLEEP_CYCLES = 100_000_000        # ~50 ms at the H100's 1.98 GHz


def _inputs(torch, seed, N, L, H, bias_kind):
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = 64 * H
    qkv = torch.randn(N, L, 3 * D, generator=g, device="cuda").bfloat16()
    dout = torch.randn(N, L, D, generator=g, device="cuda").bfloat16()
    bias = None
    if bias_kind is not None:
        lens = torch.randint(1, L + 1, (N,), generator=g, device="cuda")
        j = torch.arange(L, device="cuda")
        pad = torch.where(j[None, :] < lens[:, None], 0.0, -1e9 if
                          bias_kind == "causal" else -1e6)
        if bias_kind == "causal":
            causal = torch.where(j[None, :] > j[:, None], -1e9, 0.0)
            bias = (causal[None] + pad[:, None, :]).contiguous()
        else:
            bias = pad[:, None, :].expand(N, L, L).contiguous()
    return qkv, dout, bias


def _call_ms(torch, fn, reps):
    """Median ms of one call between two CUDA events (host and device)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(torch, fn, reps):
    """(ms per call of `reps` calls queued behind a sleep kernel, whether
    the host queued them all within the sleep)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    s0 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, queued_ms < s0.elapsed_time(a)


def _worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from neighborretr_tpu_torch.ops import _build
    from neighborretr_tpu_torch.ops import attention as A

    def host_us(fn, n=200):       # K9's 400 launches fit the launch queue
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * t / n

    new = "return_lse" in inspect.signature(A.frame_attention).parameters
    fwd_c = _build.function("frame_attention", "frame_attention_fwd",
                            A._FWD_ARGTYPES)
    bwd_c = _build.function("frame_attention", "frame_attention_bwd",
                            A._BWD_ARGTYPES)
    P = _build.ptr
    result = {"tree": tree, "saves_lse": new, "shapes": {}}
    for name, N, L, H, kind in SHAPES:
        D = 64 * H
        qkv, dout, bias = _inputs(torch, 1, N, L, H, kind)
        if new:
            out, lse = A.frame_attention(qkv, H, bias, return_lse=True)
            fwd = lambda: A.frame_attention(qkv, H, bias, return_lse=True)
            bwd = lambda: A.frame_attention_bwd(qkv, H, dout, bias, out=out,
                                                lse=lse)
        else:
            out = A.frame_attention(qkv, H, bias)
            lse = torch.empty((N, H, L), dtype=torch.float32, device="cuda")
            fwd = lambda: A.frame_attention(qkv, H, bias)
            bwd = lambda: A.frame_attention_bwd(qkv, H, dout, bias)
        reps = 50 if L <= 64 else 10
        row = {}
        for kern, fn in (("K8", fwd), ("K9", bwd)):
            dev, queued = _device_ms(torch, fn, reps)
            row[kern] = {"call_ms": _call_ms(torch, fn, reps),
                         "device_ms": dev, "queued": queued}
        if N == 128:
            row["K8"]["host_us"] = host_us(fwd)
            row["K9"]["host_us"] = host_us(bwd)
            s = torch.cuda.current_stream().cuda_stream
            stats = torch.empty((N, H, 3, L), dtype=torch.float32,
                                device="cuda")
            dqkv = torch.empty_like(qkv)
            pb = None if bias is None else P(bias)
            if new:
                c_fwd = lambda: fwd_c(P(qkv), pb, P(out), P(lse), N, L, D, H,
                                      s)
                c_bwd = lambda: bwd_c(P(qkv), pb, P(dout), P(out), P(lse),
                                      P(stats), P(dqkv), N, L, D, H, s)
            else:
                c_fwd = lambda: fwd_c(P(qkv), pb, P(out), N, L, D, H, s)
                c_bwd = lambda: bwd_c(P(qkv), pb, P(dout), P(stats),
                                      P(dqkv), N, L, D, H, s)

            def guard():
                with torch.cuda.device(qkv.device):
                    pass

            dev_index = torch.cuda.current_device()
            row["host_pieces_us"] = {
                "check": host_us(lambda: A._check_cuda_args(qkv, H, bias)),
                "empty_out": host_us(lambda: torch.empty(
                    (N, L, D), dtype=qkv.dtype, device=qkv.device)),
                "empty_lse": host_us(lambda: torch.empty(
                    (N, H, L), dtype=torch.float32, device=qkv.device)),
                "device_guard": host_us(guard),
                "stream_public": host_us(
                    lambda: torch.cuda.current_stream().cuda_stream),
                "stream_raw": host_us(
                    lambda: torch._C._cuda_getCurrentRawStream(dev_index)),
                "c_fwd": host_us(c_fwd), "c_bwd": host_us(c_bwd)}
        result["shapes"][name] = row
        del qkv, dout, bias, out, lse
        torch.cuda.empty_cache()
    return result


def _sdpa(tree: str) -> dict:
    """K8 / K9 against the library's call in turns, in one process."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F
    from neighborretr_tpu_torch.ops import attention as A

    result = {}
    for name, N, L, H, kind in SHAPES:
        D = 64 * H
        qkv, dout, bias = _inputs(torch, 1, N, L, H, kind)
        out, lse = A.frame_attention(qkv, H, bias, return_lse=True)
        q, k, v = (t.view(N, L, H, 64).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        mask = None if bias is None else bias.bfloat16()[:, None]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        lib_g = dout.view(N, L, H, 64).transpose(1, 2)
        fns = {"K8": lambda: A.frame_attention(qkv, H, bias, return_lse=True),
               "SDPA": lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask),
               "K9": lambda: A.frame_attention_bwd(qkv, H, dout, bias,
                                                   out=out, lse=lse),
               "SDPA bwd": lambda: torch.autograd.grad(
                   lib, leaves, lib_g, retain_graph=True)}
        reps = 50 if L <= 64 else 10
        row = {k: {"device_ms": [], "call_ms": []} for k in fns}
        for _ in range(3):
            for kern in ("K8", "SDPA", "SDPA", "K8", "K9", "SDPA bwd",
                         "SDPA bwd", "K9"):
                row[kern]["device_ms"].append(
                    _device_ms(torch, fns[kern], reps)[0])
                row[kern]["call_ms"].append(_call_ms(torch, fns[kern], reps))
        for key in ("device_ms", "call_ms"):
            row[f"K8 / SDPA {key}"] = (statistics.mean(row["K8"][key])
                                       / statistics.mean(row["SDPA"][key]))
            row[f"K9 / SDPA bwd {key}"] = (
                statistics.mean(row["K9"][key])
                / statistics.mean(row["SDPA bwd"][key]))
        result[name] = row
        del qkv, dout, bias, out, lse, lib, leaves
        torch.cuda.empty_cache()
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a", nargs="?")
    ap.add_argument("tree_b", nargs="?")
    ap.add_argument("--sdpa", default=None)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(_worker(args.worker)))
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi: no card")
    if args.sdpa:
        res = _sdpa(args.sdpa)
        for name, row in res.items():
            print(f"{name}:")
            for kern in ("K8", "SDPA", "K9", "SDPA bwd"):
                for key in ("device_ms", "call_ms"):
                    print(f"  {kern} {key:9s} " + " ".join(
                        f"{t:.4f}" for t in row[kern][key]))
            print("  kernel / library (means): " + ", ".join(
                f"{k} {v:.3f}" for k, v in row.items() if "/" in k))
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "sdpa": res}, f, indent=1)
        return
    runs = []
    for label, tree in (("A", args.tree_a), ("B", args.tree_b),
                        ("B", args.tree_b), ("A", args.tree_a)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            args.tree_a, args.tree_b, "--worker", tree],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            sys.exit(f"{label} ({tree}) failed:\n{r.stdout[-2000:]}\n"
                     f"{r.stderr[-4000:]}")
        runs.append((label, json.loads(r.stdout.strip().splitlines()[-1])))
        print(f"turn {len(runs)}: {label} = {tree} done")
    for name, *_ in SHAPES:
        print(f"{name}:")
        for kern in ("K8", "K9"):
            for key in ("call_ms", "device_ms", "host_us"):
                vals = [(lab, r["shapes"][name][kern].get(key))
                        for lab, r in runs]
                if vals[0][1] is None:
                    continue
                print(f"  {kern} {key:9s} " + " / ".join(
                    f"{lab} {v:.4f}" for lab, v in vals))
            if not all(r["shapes"][name][kern]["queued"] for _, r in runs):
                print(f"  {kern}: the host did not queue every call within "
                      "the sleep: device_ms includes host time")
        pieces = [(lab, r["shapes"][name].get("host_pieces_us"))
                  for lab, r in runs]
        if pieces[0][1]:
            for key in pieces[0][1]:
                print(f"  host {key:14s} us " + " / ".join(
                    f"{lab} {p[key]:.2f}" for lab, p in pieces))
    steps = []
    if args.step:
        code = ("import chip_smoke as cs; card = cs.phase_device(); "
                "cs.phase_build(); cs.phase_train(False, card, 'fused')")
        for label, tree in (("A", args.tree_a), ("B", args.tree_b),
                            ("B", args.tree_b), ("A", args.tree_a)):
            r = subprocess.run([sys.executable, "-c", code], cwd=tree,
                               capture_output=True, text=True, timeout=900)
            lines = [ln.strip() for ln in r.stdout.splitlines()
                     if "ms/step" in ln]
            if r.returncode or not lines:
                sys.exit(f"phase 12b of {label} ({tree}) failed:\n"
                         f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
            steps.append((label, lines))
            print(f"phase 12b, {label} = {tree}:", *lines, sep="\n  ")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "steps": steps}, f,
                      indent=1)


if __name__ == "__main__":
    main()
