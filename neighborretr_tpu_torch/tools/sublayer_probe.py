"""The attention sublayer's kernels (K1 / K3: ln_attention_residual and its
backward; K10 / K11: attention_sublayer and its backward) for two trees of
this repository in turns on one card.

    git archive <commit> | tar -x -C build/parent     # the tree to compare
    python3 -m neighborretr_tpu_torch.tools.sublayer_probe build/parent . \
        [--step] [--out FILE.json]

Each tree runs in a process of its own that imports that tree's package, in
the order A, B, B, A: K1 and K3 at the nine shapes of chip_smoke.py's phase
3 (serving, train step, long-token trainer: vision, text, temporal), K10
and K11 at phase 14's four, the same inputs from one seed in every process.
Per kernel and shape:

  call_ms    one wrapper call between two CUDA events, the median of many
             (phases 3, 6 and 14's `time_ms`: host and device time);
  device_ms  the wrapper called `reps` times behind a sleep kernel that
             holds the stream until every call is queued, over reps: the
             kernels' own time (`queued` says whether the host did queue
             them all within the sleep).

It then prints, from the device times (mean of the two turns of each
tree), B's speed-up over A at every shape and B - A in microseconds, and
checks two criteria: K1 and K3 at least 2x faster at the vision shapes
(N = 768, 1024, 1536), and no shape slower by more than 10 us.

--step then runs each tree's chip_smoke.py phase 8 (the ViT-B/32 train run
on the block route, every attention sublayer through K1/K3) in turns A, B,
B, A and prints its ms/step and peak-memory line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# (name, N, L, D, H, bias): chip_smoke.py's phase 3 (K1, K3) and phase 14
# (K10, K11)
LN_SHAPES = [("vision", 768, 50, 768, 12, None),
             ("text", 64, 24, 512, 8, "causal"),
             ("temporal", 64, 12, 512, 8, "keypad"),
             ("vision train", 1536, 50, 768, 12, None),
             ("text train", 128, 24, 512, 8, "causal"),
             ("temporal train", 128, 12, 512, 8, "keypad"),
             ("vision long", 1024, 50, 768, 12, None),
             ("text long", 128, 64, 512, 8, "causal"),
             ("temporal long", 128, 64, 512, 8, "keypad")]
NOLN_SHAPES = [("vision check", 768, 50, 768, 12, None),
               ("vision train", 1536, 50, 768, 12, None),
               ("text", 128, 24, 512, 8, "causal"),
               ("temporal", 128, 12, 512, 8, "keypad")]
VISION = ("vision", "vision train", "vision long")   # the 2x criterion
SPEEDUP, SLOWER_US = 2.0, 10.0
SLEEP_CYCLES = 200_000_000        # ~100 ms at the H100's 1.98 GHz


def _inputs(torch, seed, N, L, D, bias_kind):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    args = (rn(N, L, D).bfloat16(), 1 + rn(D, std=0.1), rn(D, std=0.1),
            rn(3 * D, D, std=D ** -0.5).bfloat16(), rn(3 * D, std=0.1),
            rn(D, D, std=D ** -0.5).bfloat16(), rn(D, std=0.1))
    dy = rn(N, L, D).bfloat16()
    bias = None
    if bias_kind is not None:
        lens = torch.randint(1, L + 1, (N,), generator=g, device="cuda")
        j = torch.arange(L, device="cuda")
        fill = -1e9 if bias_kind == "causal" else -1e6
        pad = torch.where(j[None, :] < lens[:, None], 0.0, fill)
        if bias_kind == "causal":
            causal = torch.where(j[None, :] > j[:, None], -1e9, 0.0)
            bias = (causal[None] + pad[:, None, :]).contiguous()
        else:
            bias = pad[:, None, :].expand(N, L, L).contiguous()
    return args, dy, bias


def _worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from neighborretr_tpu_torch.ops import block_attention as BA

    def call_ms(fn, reps):
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

    def device_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        s0 = torch.cuda.Event(enable_timing=True)
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

    result = {"tree": tree, "K1K3": {}, "K10K11": {}}
    for name, N, L, D, H, kind in LN_SHAPES:
        args, dy, bias = _inputs(torch, 1, N, L, D, kind)
        fns = {"K1": lambda: BA.ln_attention_residual(*args, H, bias),
               "K3": lambda: BA.ln_attention_residual_bwd(*args, H, dy, bias)}
        result["K1K3"][name] = _time(fns, N, call_ms, device_ms)
        del args, dy, bias
        torch.cuda.empty_cache()
    for name, N, L, D, H, kind in NOLN_SHAPES:
        (h, _, _, *w), dy, bias = _inputs(torch, 2, N, L, D, kind)
        fns = {"K10": lambda: BA.attention_sublayer(h, *w, H, bias),
               "K11": lambda: BA.attention_sublayer_bwd(h, *w, H, dy, bias)}
        result["K10K11"][name] = _time(fns, N, call_ms, device_ms)
        del h, w, dy, bias
        torch.cuda.empty_cache()
    return result


def _time(fns, N, call_ms, device_ms):
    # K3 / K11 launch about 13 kernels a call: 40 calls stay within the
    # launch queue, which would otherwise make the host wait behind the sleep
    reps = 20 if N >= 768 else 40
    row = {}
    for kern, fn in fns.items():
        dev, queued = device_ms(fn, reps)
        row[kern] = {"call_ms": call_ms(fn, reps), "device_ms": dev,
                     "queued": queued}
    return row


def _verdicts(runs) -> list:
    """B against A from the device times: per kernel and shape the mean of
    each tree's two turns → (kernel, shape, A ms, B ms, speed-up, B - A µs,
    failed criteria)."""
    rows = []
    for group in ("K1K3", "K10K11"):
        for name in runs[0][1][group]:
            for kern in runs[0][1][group][name]:
                t = {lab: [] for lab in "AB"}
                for lab, r in runs:
                    t[lab].append(r[group][name][kern]["device_ms"])
                a, b = statistics.mean(t["A"]), statistics.mean(t["B"])
                failed = []
                if (group == "K1K3" and name in VISION
                        and a / b < SPEEDUP):
                    failed.append(f"< {SPEEDUP:g}x")
                if 1e3 * (b - a) > SLOWER_US:
                    failed.append(f"> {SLOWER_US:g} us slower")
                rows.append((kern, name, a, b, a / b, 1e3 * (b - a), failed))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
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
    for group in ("K1K3", "K10K11"):
        for name, row in runs[0][1][group].items():
            print(f"{name}:")
            for kern in row:
                for key in ("call_ms", "device_ms"):
                    print(f"  {kern} {key:9s} " + " / ".join(
                        f"{lab} {r[group][name][kern][key]:.4f}"
                        for lab, r in runs))
                if not all(r[group][name][kern]["queued"] for _, r in runs):
                    print(f"  {kern}: the host did not queue every call "
                          "within the sleep: device_ms includes host time")
    verdicts = _verdicts(runs)
    print("device time, mean of two turns each: kernel, shape, A ms, B ms, "
          "A/B, B - A us")
    for kern, name, a, b, sp, d_us, failed in verdicts:
        print(f"  {kern} {name}: {a:.4f} {b:.4f} {sp:.2f}x {d_us:+.1f} us"
              f"{'  FAILS ' + ', '.join(failed) if failed else ''}")
    met = not any(v[-1] for v in verdicts)
    print(f"criteria (K1/K3 >= {SPEEDUP:g}x at {', '.join(VISION)}; no shape "
          f"> {SLOWER_US:g} us slower): {'met' if met else 'NOT met'}")
    steps = []
    if args.step:
        code = ("import chip_smoke as cs; card = cs.phase_device(); "
                "cs.phase_build(); cs.phase_train(False, card)")
        for label, tree in (("A", args.tree_a), ("B", args.tree_b),
                            ("B", args.tree_b), ("A", args.tree_a)):
            r = subprocess.run([sys.executable, "-c", code], cwd=tree,
                               capture_output=True, text=True, timeout=900)
            lines = [ln.strip() for ln in r.stdout.splitlines()
                     if "ms/step" in ln]
            if r.returncode or not lines:
                sys.exit(f"phase 8 of {label} ({tree}) failed:\n"
                         f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
            steps.append((label, lines))
            print(f"phase 8, {label} = {tree}:", *lines, sep="\n  ")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "verdicts": verdicts,
                       "criteria_met": met, "steps": steps}, f, indent=1)


if __name__ == "__main__":
    main()
