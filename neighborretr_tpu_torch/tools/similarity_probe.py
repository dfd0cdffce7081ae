"""The token-interaction similarity's kernels (K4 / K5: the bank centrality
and its backward; K6 / K7: the blocked long-token similarity and its
backward; K2, K4 and K6 without grad) for one or two trees of this
repository in turns on one card.

    git archive <commit> | tar -x -C build/parent     # the tree to compare
    python3 -m neighborretr_tpu_torch.tools.similarity_probe build/parent . \
        [--step] [--long] [--out FILE.json]

Each tree runs in a process of its own that imports that tree's package, in
the order A, B, B, A (one tree: once), on the same inputs from one seed.
Every call is the train step's own form: the forward under autograd on
prepared inputs (ops/similarity.py::_prepare), the backward through
`torch.autograd.grad` with `retain_graph`, and only the features that the
step differentiates asking for a gradient (the bank's side is detached:
phase 7's (128, 24, 1920, 12, 512) needs the text side, (1920, 24, 128, 12,
512) the video side; phase 9's two bank shapes likewise; the long step's
in-batch (128, 64, 128, 64, 512) both sides).  Each backward is also timed
with both sides asked for, and K4 and K6 also without grad (no residual
stores) on the same prepared inputs; K6 at the first bank shape also at D =
32, one k-chunk, whose time is mostly the tile's epilogue and the ring's
fill: `epilogue` estimates their share of the D = 512 call as t(32) less
one k-chunk's share of t(512) - t(32), over t(512).  Per call:

  call_ms    one call between two CUDA events, the median of many
             (chip_smoke.py's `time_ms`: host and device time);
  device_ms  the call made `reps` times behind a sleep kernel that holds
             the stream until every call is queued, over reps (`queued`
             says whether the host did queue them all within the sleep);
  stages     device ms per call by kernel name (torch.profiler over a few
             calls): the tile kernel, the gathers, the reduces, and for
             the public wrappers the inputs' normalisation;
  sha256     of the output (two trees must agree bit for bit where their
             kernel is the same: K2 and K4);
  l2_tb_s    for the tile kernel of this tree's design (similarity_tile.cuh
             at the long-token tiling), the bytes its TMA loads bring from
             L2 into shared memory over device_ms, in TB/s.

Each tree's K2 also reports its accuracy (`accuracy`) at the bank shape
(128, 24, 1920, 12, 512) and at serving's Q=64, and K6 at 64 of the 128
captions of its bank shape (64, 64, 1920, 64, 512; float64 logits of 4 GB):
the largest distance from float64 of S and of the two maxima the backward
routes by (m1, m2), for the kernel, the fp32 plain version (cuBLAS; K6's
chunked) and, where the tree has it, ops/similarity.py::similarity_tf32x3
(the kernel's split written out, its sums cuBLAS's), and how many saved
indices differ from the plain first argmax and from float64's.

K2 at the serving shapes (Q = 1, 8 and 64 queries against N=10,000 videos)
and K6 at the eval shape (1,024 x 1,024) run without grad through the
public wrappers.  It then prints, from the device times (mean of each
tree's two turns), B's speed-up over A, and checks the criteria in
CRITERIA and SAME_BITS: K6 in the train step's form (autograd, residual
stores) at both bank shapes and without grad at the eval shape at least
1.5x, the in-batch K6 call at most 10% slower, K5 and K7 within 3%, K2 and
K4 bit-equal; and that tree B's K6 lies no farther from float64 than the
fp32 plain version in S, m1 and m2.

--long also profiles one long-token train step per turn (ViT-B/32, 64
words x 64 frames, batch 128 as 8 micro-batches, bank 1920, random bank
features as chip_smoke.py --profile does) and prints its device time;
--step runs each tree's chip_smoke.py phase 8 (the flagship train run) in
turns A, B, B, A and prints its ms/step lines.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# (name, A, T, B, V, D, axis or None, side the train step needs)
FLAT = [("K4/K5 cent_t", 128, 24, 1920, 12, 512, 1, "text"),
        ("K4/K5 cent_v", 1920, 24, 128, 12, 512, 0, "video")]
BLOCKED = [("K6/K7 bank t2v", 128, 64, 1920, 64, 512, None, "text"),
           ("K6/K7 bank v2t", 1920, 64, 128, 64, 512, None, "video"),
           ("K6/K7 in-batch", 128, 64, 128, 64, 512, None, "both")]
SERVE_Q = (1, 8, 64)                     # queries against the corpus
SERVE = (24, 10000, 12, 512)             # T, N, V, D
EVAL = (1024, 64, 1024, 64, 512)
# (shape, call) -> (least, most) speed-up of B over A (A / B of the device
# times)
WITHIN_3 = (1 / 1.03, 1.03)
CRITERIA = {("K6/K7 bank t2v", "K6"): (1.5, None),
            ("K6/K7 bank v2t", "K6"): (1.5, None),
            ("K6 eval 1024 x 1024", "K6 no grad"): (1.5, None),
            ("K6/K7 in-batch", "K6"): (1 / 1.10, None),
            **{(name, call): WITHIN_3
               for name, call in (("K4/K5 cent_t", "K5 train"),
                                  ("K4/K5 cent_t", "K5 both"),
                                  ("K4/K5 cent_v", "K5 train"),
                                  ("K4/K5 cent_v", "K5 both"),
                                  ("K6/K7 bank t2v", "K7 train"),
                                  ("K6/K7 bank t2v", "K7 both"),
                                  ("K6/K7 bank v2t", "K7 train"),
                                  ("K6/K7 bank v2t", "K7 both"),
                                  ("K6/K7 in-batch", "K7 train"))}}
SAME_BITS = ("K2", "K4")                 # kernels both trees share
ACCURACY_K6 = "K6 bank 64 x 1920"
SLEEP_CYCLES = 200_000_000               # ~100 ms at the H100's 1.98 GHz
# the similarity family's kernels in a profile, by name (either tree's)
SIMILARITY_KERNELS = ("similarity_kernel<", "blocked_similarity_kernel<",
                      "blocked_tile_kernel",
                      "bwd_text_kernel", "bwd_video_kernel",
                      "routed_gather_kernel", "routed_weight_grad_kernel",
                      "reduce_rows_kernel(")
TRAINER_ARGV = [
    "--datatype", "synthetic", "--clip_checkpoint", "random",
    "--max_words", "64", "--max_frames", "64", "--batch_size", "128",
    "--mb_batch", "15", "--micro_batches", "8", "--epochs", "1",
    "--synthetic_size", "384", "--batch_size_val", "256", "--workers", "0",
    "--seed", "42"]


def _raw(torch, seed, A, T, B, V, D):
    """Features, ragged masks and softmax token weights, as chip_smoke.py's
    phase 7 makes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tf = torch.randn(A, T, D, generator=g, device="cuda")
    vf = torch.randn(B, V, D, generator=g, device="cuda")
    tlen = torch.randint(4, T + 1, (A,), generator=g, device="cuda")
    vlen = torch.randint(1, V + 1, (B,), generator=g, device="cuda")
    tm = (torch.arange(T, device="cuda")[None] < tlen[:, None]).float()
    vm = (torch.arange(V, device="cuda")[None] < vlen[:, None]).float()
    tw = torch.softmax(torch.randn(A, T, generator=g, device="cuda")
                       .masked_fill(tm == 0, -9e15), -1)
    vw = torch.softmax(torch.randn(B, V, generator=g, device="cuda")
                       .masked_fill(vm == 0, -9e15), -1)
    return tf, vf, tm, vm, tw, vw


def _sha(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def _by_name(trace) -> dict:
    """Device ms of a profile by kernel name."""
    from torch.autograd import DeviceType
    return {e.key[:90]: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)) / 1e3
            for e in trace.key_averages() if e.device_type == DeviceType.CUDA}


def _stages(torch, fn, calls=3) -> dict:
    """Device ms per call by kernel name over `calls` calls of fn."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_call = {k: v / calls for k, v in _by_name(trace).items() if v > 0}
    return dict(sorted(per_call.items(), key=lambda kv: -kv[1]))


def _k6_tma_bytes(A, T, B, V, D) -> int:
    """Bytes the long-token tile kernel's TMA loads bring into shared memory
    (csrc/interaction_similarity_blocked.cu's tiling of
    csrc/similarity_tile.cuh): per block and 32-column k-chunk MT·64 text
    rows and 2 x 128 video rows of 128 bytes."""
    vp = 16 if V <= 16 else 32 if V <= 32 else 64
    qb = 8
    while qb > 1 and ((qb * T + 63) // 64 > 2 or qb // 2 >= A):
        qb //= 2
    mt = (qb * T + 63) // 64
    videos = 2 * (128 // vp)
    blocks = -(-A // qb) * -(-B // videos)
    return blocks * -(-D // 32) * (mt * 64 + 2 * 128) * 128


def _accuracy(torch, S, raw, fwd=None, plain_fn=None) -> dict:
    """The kernel's S and routing (under autograd's residual stores) and the
    plain version's against float64 logits of the same prepared inputs
    (K2's by default; K6's with fwd / plain_fn)."""
    tn, vn, tw, vw = [x.detach() for x in S._prepare(*raw, False)]
    (A, T, D), (B, V, _) = tn.shape, vn.shape
    fwd = fwd or S._similarity_fwd
    out, (m1, i1, m2, i2) = fwd(tn, vn, tw, vw, save=True)
    plain, (p1, j1, p2, j2) = (plain_fn or S.similarity_routing_plain)(
        tn, vn, tw, vw)
    lg = (tn.reshape(A * T, D).double() @ vn.reshape(B * V, D).double().T
          ).reshape(A, T, B, V)

    def first_max(x, dim):             # the max and its first index
        m = x.amax(dim, keepdim=True)
        n = x.shape[dim]
        pos = torch.arange(n, device=x.device).view(
            [n if d == dim else 1 for d in range(x.dim())])
        return m.squeeze(dim), torch.where(x == m, pos, n).amin(dim)

    e1, x1 = (t.transpose(1, 2) for t in first_max(lg, 3))   # [A, B, T]
    e2, x2 = first_max(lg, 1)                                # [A, B, V]
    del lg
    exact = 0.5 * (torch.einsum("abt,at->ab", e1, tw.double())
                   + torch.einsum("abv,bv->ab", e2, vw.double()))

    def dist(got, want):
        return (got.double() - want).abs().max().item()

    i1, i2 = i1[..., :T].long(), i2[..., :V].long()
    rows = {"kernel": {"S": dist(out, exact), "m1": dist(m1, e1),
                       "m2": dist(m2, e2)},
            "cuBLAS": {"S": dist(plain, exact), "m1": dist(p1, e1),
                       "m2": dist(p2, e2)}}
    if hasattr(S, "similarity_tf32x3"):     # the kernel's split, written out
        em, (q1, _, q2, _) = S.similarity_tf32x3(tn, vn, tw, vw)
        rows["emulation"] = {"S": dist(em, exact), "m1": dist(q1, e1),
                             "m2": dist(q2, e2)}
    return {**rows,
            "indices": A * B * (T + V),
            "kernel vs plain": int((i1 != j1.long()).sum()
                                   + (i2 != j2.long()).sum()),
            "kernel vs float64": int((i1 != x1).sum() + (i2 != x2).sum()),
            "plain vs float64": int((j1.long() != x1).sum()
                                    + (j2.long() != x2).sum())}


def _worker(tree: str, long_step: bool) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from neighborretr_tpu_torch.ops import similarity as S
    from neighborretr_tpu_torch.ops import similarity_blocked as SB
    torch.backends.cuda.matmul.allow_tf32 = False

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

    def timed(fn, reps, stages=False):
        dev, queued = device_ms(fn, reps)
        row = {"call_ms": call_ms(fn, reps), "device_ms": dev,
               "queued": queued}
        if stages:
            row["stages"] = _stages(torch, fn)
        return row

    result = {"tree": tree, "shapes": {}, "accuracy": {}}
    for name, A, T, B, V, D in (("bank 128 x 1920", 128, 24, 1920, 12, 512),
                                ("serving Q=64", 64, *SERVE)):
        result["accuracy"][name] = _accuracy(
            torch, S, _raw(torch, A + B + T, A, T, B, V, D))
        torch.cuda.empty_cache()
    # K6: the first 64 captions of its bank shape's inputs
    raw = _raw(torch, 128 + 1920 + 64, 128, 64, 1920, 64, 512)
    result["accuracy"][ACCURACY_K6] = _accuracy(
        torch, S, [raw[0][:64], raw[1], raw[2][:64], raw[3], raw[4][:64],
                   raw[5]], SB._blocked_fwd, SB.similarity_blocked_routing_plain)
    del raw
    torch.cuda.empty_cache()
    for name, A, T, B, V, D, axis, side in FLAT + BLOCKED:
        raw = _raw(torch, A + B + T, A, T, B, V, D)
        prep = [x.detach() for x in S._prepare(*raw, False)]
        g = torch.Generator(device="cuda").manual_seed(7)
        n_out = (A, B) if axis is None else ((A,) if axis == 1 else (B,))
        cot = torch.randn(*n_out, generator=g, device="cuda")
        if axis is None:
            fwd = lambda *x: SB._BlockedSimilarity.apply(*x, True)
            kern = ("K6", "K7")
        else:
            fwd = lambda *x: S._Similarity.apply(*x, axis, True)
            kern = ("K4", "K5")
        row = {}
        for form, feats in (("train", side), ("both", "both")):
            if form == "both" and side == "both":
                continue
            leaves = [x.clone().requires_grad_(
                i >= 2 or feats == "both"
                or (i == 0) == (feats == "text")) for i, x in enumerate(prep)]
            out = fwd(*leaves)
            need = [x for x in leaves if x.requires_grad]
            if form == "train":
                row[kern[0]] = timed(lambda: fwd(*leaves), 10, stages=True)
                row[kern[0]]["sha256"] = _sha(out)
                if axis is not None:
                    row["K4 no grad"] = timed(
                        lambda: S._mean_fwd(*prep, axis), 10, stages=True)
                    row["K4 no grad"]["sha256"] = _sha(
                        S._mean_fwd(*prep, axis)[0])
                else:
                    row["K6 no grad"] = timed(
                        lambda: SB._blocked_fwd(*prep, save=False), 10,
                        stages=True)
                    for call in ("K6", "K6 no grad"):
                        row[call]["l2_tb_s"] = _k6_tma_bytes(
                            A, T, B, V, D) / row[call]["device_ms"] / 1e9
            row[f"{kern[1]} {form}"] = timed(
                lambda: torch.autograd.grad(out, need, cot,
                                            retain_graph=True), 10,
                stages=True)
            del out, need, leaves
        if name == BLOCKED[0][0]:
            # one k-chunk: the epilogue, the ring's fill and one chunk
            one = [x.detach() for x in S._prepare(
                *_raw(torch, A + B + T, A, T, B, V, 32), False)]
            row["K6 no grad D=32"] = timed(
                lambda: SB._blocked_fwd(*one, save=False), 10)
            t32 = row["K6 no grad D=32"]["device_ms"]
            t512 = row["K6 no grad"]["device_ms"]
            row["K6 no grad D=32"]["epilogue"] = (
                t32 - (t512 - t32) / (D // 32 - 1)) / t512
            del one
        result["shapes"][name] = row
        del raw, prep
        torch.cuda.empty_cache()

    # without grad, through the public wrappers
    with torch.no_grad():
        for q in SERVE_Q:
            raw = _raw(torch, 1, q, *SERVE)
            out = S.fused_interaction_similarity(*raw)
            row = {"K2": timed(lambda: S.fused_interaction_similarity(*raw),
                               20, stages=True)}
            row["K2"]["sha256"] = _sha(out)
            result["shapes"][f"K2 serving Q={q} N={SERVE[1]}"] = row
        raw = _raw(torch, 2, *EVAL)
        out = SB.fused_interaction_similarity_blocked(*raw)
        row = {"K6 no grad": timed(
            lambda: SB.fused_interaction_similarity_blocked(*raw), 5,
            stages=True)}
        row["K6 no grad"]["sha256"] = _sha(out)
        row["K6 no grad"]["l2_tb_s"] = _k6_tma_bytes(
            *EVAL) / row["K6 no grad"]["device_ms"] / 1e9
        result["shapes"]["K6 eval 1024 x 1024"] = row
    del raw, out
    torch.cuda.empty_cache()

    if long_step:
        result["long_step"] = _long_step(torch)
    return result


def _long_step(torch) -> dict:
    """One long-token train step after a warm-up step, profiled: device ms
    in all and of the similarity kernels, host ms."""
    from neighborretr_tpu_torch.cli import train as cli
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        make_synthetic_batch
    from neighborretr_tpu_torch.models import weights_io
    from neighborretr_tpu_torch.train import loop as LOOP
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as out_dir:
        cfg = cli.build_config(cli.parse_args(TRAINER_ARGV
                                              + ["--output_dir", out_dir]))
    m, B = cfg.model, cfg.train.batch_size
    model = weights_io.init_model(m, cfg.train.seed, "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    bank = MB.create(cfg.train.memory_bank_capacity, m.max_words,
                     m.max_frames, m.width, device="cuda")
    bank = bank._replace(
        feat_t=torch.randn(bank.feat_t.shape, generator=g, device="cuda"),
        feat_v=torch.randn(bank.feat_v.shape, generator=g, device="cuda"),
        mask_t=torch.ones_like(bank.mask_t),
        mask_v=torch.ones_like(bank.mask_v))
    state = TS.create_train_state(model, bank)
    batches = [TS.to_device(make_synthetic_batch(m, B, seed=s), "cuda")
               for s in (8, 9)]
    state, _ = TS.train_step(state, batches[0], cfg, 10,
                             LOOP.step_generator(0, 0, "cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        state, met = TS.train_step(state, batches[1], cfg, 10,
                                   LOOP.step_generator(0, 1, "cuda"))
        torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    by_name = _by_name(trace)
    sims = {k: v for k, v in by_name.items()
            if any(s in k for s in SIMILARITY_KERNELS)}
    return {"device_ms": sum(by_name.values()), "host_ms": host_ms,
            "loss": met["loss"].item(), "similarity_kernels_ms": sims,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _verdicts(runs) -> list:
    """B against A from the device times (mean of each tree's turns) →
    (shape, call, A ms, B ms, A / B, failed criteria)."""
    rows = []
    first = runs[0][1]["shapes"]
    for name, calls in first.items():
        for call in calls:
            t = {lab: [r["shapes"][name][call]["device_ms"]
                       for lab2, r in runs if lab2 == lab] for lab in "AB"}
            a = statistics.mean(t["A"])
            b = statistics.mean(t["B"]) if t["B"] else a
            failed = []
            least, most = CRITERIA.get((name, call), (None, None))
            if least is not None and a / b < least:
                failed.append(f"< {least:.3g}x")
            if most is not None and a / b > most:
                failed.append(f"> {most:.3g}x")
            shas = {r["shapes"][name][call].get("sha256") for _, r in runs}
            if (call.split()[0] in SAME_BITS and None not in shas
                    and len(shas) > 1):
                failed.append("bits differ")
            rows.append((name, call, a, b, a / b, failed))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b", nargs="?")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(_worker(args.worker, args.long)))
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi: no card")
    turns = ((("A", args.tree_a), ("B", args.tree_b), ("B", args.tree_b),
              ("A", args.tree_a)) if args.tree_b else (("A", args.tree_a),))
    runs = []
    for label, tree in turns:
        cmd = [sys.executable, os.path.abspath(__file__), args.tree_a,
               "--worker", tree] + (["--long"] if args.long else [])
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
        if r.returncode:
            sys.exit(f"{label} ({tree}) failed:\n{r.stdout[-2000:]}\n"
                     f"{r.stderr[-4000:]}")
        runs.append((label, json.loads(r.stdout.strip().splitlines()[-1])))
        print(f"turn {len(runs)}: {label} = {tree} done", flush=True)
    for name, calls in runs[0][1]["shapes"].items():
        print(f"{name}:")
        for call in calls:
            for key in ("call_ms", "device_ms"):
                print(f"  {call} {key:9s} " + " / ".join(
                    f"{lab} {r['shapes'][name][call][key]:.4f}"
                    for lab, r in runs))
            if not all(r["shapes"][name][call]["queued"] for _, r in runs):
                print(f"  {call}: the host did not queue every call within "
                      "the sleep: device_ms includes host time")
            for lab, r in runs[:2] if args.tree_b else runs:
                row = r["shapes"][name][call]
                st = row.get("stages")
                if st:
                    print(f"  {call} stages ({lab}): " + "; ".join(
                        f"{k} {v:.4f}" for k, v in st.items()))
                if "l2_tb_s" in row:
                    print(f"  {call} ({lab}): {row['l2_tb_s']:.3f} TB/s from"
                          " L2 into shared memory, if this is the tiling of "
                          "similarity_tile.cuh")
                if "epilogue" in row:
                    print(f"  {call} ({lab}): the epilogue and the ring's "
                          f"fill about {100 * row['epilogue']:.1f}% of the "
                          "D = 512 call")
    for lab, r in runs:
        if "long_step" in r:
            ls = r["long_step"]
            print(f"long step ({lab}): device {ls['device_ms']:.3f} ms, host "
                  f"{ls['host_ms']:.1f} ms, peak {ls['peak_gib']:.2f} GiB, "
                  f"loss {ls['loss']:.6f}; similarity kernels: " + "; ".join(
                      f"{k} {v:.3f}" for k, v in
                      ls["similarity_kernels_ms"].items()))
    for lab, r in runs[:2] if args.tree_b else runs:
        for name, acc in r["accuracy"].items():
            print(f"accuracy ({lab}), {name}: max |x - float64| of S / m1 / "
                  "m2: kernel " + " / ".join(
                      f"{acc['kernel'][k]:.3g}" for k in ("S", "m1", "m2"))
                  + ", cuBLAS " + " / ".join(
                      f"{acc['cuBLAS'][k]:.3g}" for k in ("S", "m1", "m2"))
                  + (", similarity_tf32x3 " + " / ".join(
                      f"{acc['emulation'][k]:.3g}" for k in ("S", "m1", "m2"))
                     if "emulation" in acc else "")
                  + f"; of {acc['indices']} saved indices "
                  f"{acc['kernel vs plain']} differ from the plain first "
                  f"argmax, {acc['kernel vs float64']} from float64's "
                  f"(the plain's: {acc['plain vs float64']})")
    k6_acc = runs[1 if args.tree_b else 0][1]["accuracy"][ACCURACY_K6]
    k6_close = all(k6_acc["kernel"][k] <= k6_acc["cuBLAS"][k]
                   for k in ("S", "m1", "m2"))
    print(f"K6 ({'B' if args.tree_b else 'A'}) as close to float64 as the "
          f"fp32 plain version in S, m1 and m2: {'yes' if k6_close else 'NO'}")
    verdicts = _verdicts(runs) if args.tree_b else []
    if verdicts:
        print("device time, mean of two turns each: shape, call, A ms, B ms,"
              " A/B")
        for name, call, a, b, sp, failed in verdicts:
            print(f"  {name} {call}: {a:.4f} {b:.4f} {sp:.2f}x"
                  f"{'  FAILS ' + ', '.join(failed) if failed else ''}")
        met = k6_close and not any(v[-1] for v in verdicts)
        print(f"criteria (K6 in the train step's form at both bank shapes "
              f"and without grad at the eval shape >= 1.5x; the in-batch K6 "
              f"<= 10% slower; K5 and K7 within 3%; K2 and K4 bit-equal; K6 "
              f"as close to float64 as the fp32 plain version): "
              f"{'met' if met else 'NOT met'}")
    steps = []
    if args.step:
        code = ("import chip_smoke as cs; card = cs.phase_device(); "
                "cs.phase_build(); cs.phase_train(False, card)")
        for label, tree in turns:
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
                       "steps": steps}, f, indent=1)


if __name__ == "__main__":
    main()
