#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — builds both hand-written kernels from csrc/ with nvcc;
  3. K1      — the fused LN-attention sublayer against its plain version on
               the card at the three main-path shapes (vision, text, temporal);
  4. K2      — the similarity kernel against its plain version at
               Q=64, T=24, N=10,000, V=12, D=512;
  5. serving — indexes a 128-video synthetic corpus with the full-width
               ViT-B/32 model (seeded random weights, bf16) and answers
               three requests of 1, 8 and 64 queries through a Searcher;
               checks the kernels' launch counts in that run, that all
               scores are finite, and that they match a run of the plain
               versions on the card.
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is the device record.

Imports only torch, numpy and the port (no JAX).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# stated tolerances, |kernel - plain| <= atol + rtol * |plain|:
# K1 returns bf16: two bf16 rounding steps (2^-6 relative) cover the
# one-ulp flips that differently ordered fp32 sums cause at its rounding
# points.  K2 is fp32 end to end: the JAX suite's kernel tolerance.
K1_TOL = (2 ** -6, 2 ** -6)
K2_TOL = (2e-5, 1e-4)
# serving scores: bf16 towers of 12 + 4 (video) and 12 (text) layers,
# where a one-ulp flip in one layer carries into the next; scores are
# O(0.1) cosine-like sums (observed max 6.4e-4 on an H100)
SERVE_TOL = (5e-3, 0.0)


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` on the current stream (CUDA events)."""
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


def compare(name, got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
    max_abs = err.max().item()
    max_rel = (err / want.abs().clamp_min(1e-6)).max().item()
    print(f"  {name}: max_abs_err {max_abs:.6g} max_rel_err {max_rel:.6g} "
          f"(tolerance atol {atol:g} + rtol {rtol:g}·|plain|) "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return max_abs


def phase_device():
    print("== phase 1: device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    print("== phase 2: build")
    from neighborretr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load("interaction_similarity", "ln_attention_residual")
    print(f"  built in {time.perf_counter() - t0:.2f} s into {_build.build_dir()}")
    for name in ("interaction_similarity", "ln_attention_residual"):
        log = _build.compiler_log(name)
        regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
        spills = sum("spill" in ln and "0 bytes spill stores, 0 bytes spill"
                     " loads" not in ln for ln in log.splitlines())
        print(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)}"
              f" registers/thread, {spills} with register spills")


def _attn_inputs(g, N, L, D, bias_kind):
    dev = "cuda"

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = rn(N, L, D).bfloat16()
    args = (x, 1 + rn(D, std=0.1), rn(D, std=0.1),
            rn(3 * D, D, std=D ** -0.5).bfloat16(), rn(3 * D, std=0.1),
            rn(D, D, std=D ** -0.5).bfloat16(), rn(D, std=0.1))
    bias = None
    if bias_kind is not None:
        lens = torch.randint(1, L + 1, (N,), generator=g, device=dev)
        j = torch.arange(L, device=dev)
        if bias_kind == "causal":      # text: causal ∧ padding, -1e9 each
            pad = torch.where(j[None, :] < lens[:, None], 0.0, -1e9)
            causal = torch.where(j[None, :] > j[:, None], -1e9, 0.0)
            bias = causal[None] + pad[:, None, :]
        else:                          # temporal: key padding, -1e6
            pad = torch.where(j[None, :] < lens[:, None], 0.0, -1e6)
            bias = pad[:, None, :].expand(N, L, L)
        bias = bias.contiguous()
    return args, bias


def phase_k1(g):
    print("== phase 3: K1 ln_attention_residual vs its plain version")
    from neighborretr_tpu_torch.ops.block_attention import (
        ln_attention_residual, ln_attention_residual_plain)
    shapes = [("vision", 768, 50, 768, 12, None),
              ("text", 64, 24, 512, 8, "causal"),
              ("temporal", 64, 12, 512, 8, "keypad")]
    rows = {}
    for name, N, L, D, H, kind in shapes:
        args, bias = _attn_inputs(g, N, L, D, kind)
        got = ln_attention_residual(*args, H, bias)
        torch.cuda.synchronize()
        want = ln_attention_residual_plain(*args, H, bias)
        err = compare(f"{name} N={N} L={L} D={D} H={H}", got, want, K1_TOL)
        ms = time_ms(lambda: ln_attention_residual(*args, H, bias), 20)
        plain_ms = time_ms(lambda: ln_attention_residual_plain(*args, H, bias),
                           10)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rows[name] = (err, ms, plain_ms)
    return rows


def phase_k2(g):
    print("== phase 4: K2 interaction_similarity vs its plain version")
    from neighborretr_tpu_torch.ops.similarity import (
        fused_interaction_similarity, interaction_similarity)
    Q, T, N, V, D = 64, 24, 10_000, 12, 512
    dev = "cuda"
    tf = torch.randn(Q, T, D, generator=g, device=dev)
    vf = torch.randn(N, V, D, generator=g, device=dev)
    tlen = torch.randint(2, T + 1, (Q,), generator=g, device=dev)
    vlen = torch.randint(1, V + 1, (N,), generator=g, device=dev)
    tm = (torch.arange(T, device=dev)[None] < tlen[:, None]).float()
    vm = (torch.arange(V, device=dev)[None] < vlen[:, None]).float()
    tw = torch.softmax(torch.randn(Q, T, generator=g, device=dev)
                       .masked_fill(tm == 0, -9e15), -1)
    vw = torch.softmax(torch.randn(N, V, generator=g, device=dev)
                       .masked_fill(vm == 0, -9e15), -1)
    args = (tf, vf, tm, vm, tw, vw)
    got = fused_interaction_similarity(*args)
    torch.cuda.synchronize()
    want = interaction_similarity(*args)
    err = compare(f"Q={Q} T={T} N={N} V={V} D={D}", got, want, K2_TOL)
    ms = time_ms(lambda: fused_interaction_similarity(*args), 10)
    plain_ms = time_ms(lambda: interaction_similarity(*args), 5)
    print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def phase_serving():
    print("== phase 5: serving run (ViT-B/32 width, bf16, random weights)")
    from neighborretr_tpu.core.config import Config, ModelConfig
    from neighborretr_tpu.data.datasets.synthetic import SyntheticDataset
    from neighborretr_tpu.data.loader import BatchLoader
    from neighborretr_tpu.data.tokenizer import ClipTokenizer
    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.eval import (encode_video_batch,
                                             similarity_matrix_device)
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.ops.block_attention import \
        ln_attention_residual
    from neighborretr_tpu_torch.ops.similarity import \
        fused_interaction_similarity

    cfg = Config(model=ModelConfig())
    m = cfg.model
    print(f"  model: {m.clip.vision_layers}x{m.clip.vision_width} vision "
          f"(patch {m.clip.vision_patch_size}, {m.clip.image_resolution}px), "
          f"{m.clip.transformer_layers}x{m.clip.transformer_width} text, "
          f"{m.temporal_layers} temporal, {m.max_frames} frames, "
          f"{m.max_words} words, {m.compute_dtype}")
    model = init_model(m, seed=0, device="cuda")
    n_videos, batch = 128, 64
    ds = SyntheticDataset(n=n_videos, seed=2, max_words=m.max_words,
                          max_frames=m.max_frames,
                          resolution=m.clip.image_resolution,
                          vocab_size=m.clip.vocab_size)

    def loader():
        return BatchLoader(ds, batch, shuffle=False, drop_last=False,
                           workers=4, pad_to_batch=True)

    tok = ClipTokenizer()
    words = ["a man is cooking pasta in a kitchen",
             "dog catching a frisbee on the beach",
             "people dancing at a wedding", "a car drives through rain",
             "children playing football", "a woman sings on stage",
             "timelapse of clouds over mountains", "a cat sleeps on a sofa"]
    requests = [words[:1], words, [f"{w} number {i}" for i in range(8)
                                   for w in words]]

    # warm-up outside the counted run: cuBLAS/cuDNN handles and shape
    # heuristics, lazy kernel loading, the allocator, the tokenizer's cache
    first = next(iter(loader()))
    vf = encode_video_batch(model, first["video"], first["video_mask"])
    vm = torch.as_tensor(first["video_mask"], device="cuda")
    for queries in requests:
        tf, tm = serving.encode_queries(model, cfg, tok,
                                        queries + [""] * (-len(queries) % 8))
        sim = similarity_matrix_device(model, tf, tm, vf, vm)
        serving.masked_topk(sim, 8, sim.shape[1])
    torch.cuda.synchronize()

    ln_attention_residual.launches = 0
    fused_interaction_similarity.launches = 0
    t0 = time.perf_counter()
    index = serving.build_video_index(model, cfg, loader(), dataset=ds)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    searcher = serving.Searcher(model, cfg, index, tok)
    hits, latencies = [], []
    for queries in requests:
        t0 = time.perf_counter()
        hits.append(searcher.search(queries, topk=5))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    k1 = ln_attention_residual.launches
    k2 = fused_interaction_similarity.launches

    n_batches = -(-n_videos // batch)
    want_k1 = (n_batches * (m.clip.vision_layers + m.temporal_layers)
               + len(requests) * m.clip.transformer_layers)
    print(f"  launches in the serving run: K1 {k1} (expected {want_k1}), "
          f"K2 {k2} (expected {len(requests)})")
    if k1 != want_k1 or k2 != len(requests):
        raise SystemExit("launch counts do not match the serving path")
    print(f"  index: {len(index['video_ids'])} videos in {t_index:.4f} s = "
          f"{len(index['video_ids']) / t_index:.2f} videos/s "
          f"(v_feat {index['v_feat'].shape} {index['v_feat'].dtype})")
    for queries, hit, lat in zip(requests, hits, latencies):
        if len(hit) != len(queries) or any(len(h) != 5 for h in hit):
            raise SystemExit("search returned the wrong number of hits")
        scores = np.array([[s for _, s in h] for h in hit])
        if not np.isfinite(scores).all():
            raise SystemExit("non-finite search scores")
        print(f"  request of {len(queries)} queries: {lat * 1e3:.3f} ms, "
              f"top-1 {hit[0][0][0]} ({hit[0][0][1]:.4f})")

    # the same path through the plain versions on the card
    plain_index = serving.build_video_index(model, cfg, loader(), dataset=ds,
                                            kernels=False)
    plain = serving.Searcher(model, cfg, plain_index, tok, kernels=False)
    err = 0.0
    for queries in requests:
        got = torch.as_tensor(searcher.similarities(queries))
        want = torch.as_tensor(plain.similarities(queries))
        if got.shape != (len(queries), n_videos):
            raise SystemExit(f"similarities shape {tuple(got.shape)}")
        err = max(err, compare(f"[{len(queries)}, {n_videos}] scores vs plain run",
                               got, want, SERVE_TOL))
    return k1, k2, err


def main():
    phase_device()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    k1_rows = phase_k1(g)
    k2_err, k2_ms, k2_plain = phase_k2(g)
    k1_launches, k2_launches, _ = phase_serving()
    err, ms, plain_ms = k1_rows["vision"]
    record = {"kernels": [
        {"name": "ln_attention_residual", "route": "cuda",
         "source": "neighborretr_tpu_torch/csrc/ln_attention_residual.cu",
         "replaces": "neighborretr_tpu/ops/pallas_block_attention.py:500",
         "launches": k1_launches,
         "max_abs_err": max(r[0] for r in k1_rows.values()),
         "ms": ms, "plain_ms": plain_ms,
         "timed_at": "vision N=768 L=50 D=768 H=12",
         "ms_by_shape": {k: [r[1], r[2]] for k, r in k1_rows.items()}},
        {"name": "interaction_similarity", "route": "cuda",
         "source": "neighborretr_tpu_torch/csrc/interaction_similarity.cu",
         "replaces": "neighborretr_tpu/ops/pallas_similarity.py:132",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain,
         "timed_at": "Q=64 T=24 N=10000 V=12 D=512"},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
