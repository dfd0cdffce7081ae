#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU:
serving (index → search), the flagship train step (bank fill → optimizer
steps at 24 words x 12 frames), the long-token trainer (the train CLI at
64 words x 64 frames: bank fill, steps, eval, checkpoints, resume), then
serving and the train step again on the `attention_impl="fused"` route, the
index/search CLIs and rematerialised train steps at ViT-L/14@336px, the
kernel check of the sublayer without LayerNorm (`fused_attention_sublayer`),
the flagship trainer under `--augment_backend device`, the serving
daemon (the index, serve, export and export_checkpoint CLIs, HTTP load
behind the batching dispatcher, a live reload, the deployment bundle),
data parallelism over torch.distributed, the input side (an
OpenAI-layout CLIP archive and encoded clips through the pack, train,
eval, index and search CLIs), and the model-sharded strategies (tensor
parallelism, FSDP2, the pipeline, pipeline x tensor, the eval under tensor
parallelism), and the trainer's host-memory paths (the device prefetch,
host-resident moments and bank, --debug_nans).

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --alone 9 [--seeds S ...]   # phase 9 per seed
    python3 chip_smoke.py --alone 16                  # phase 16
    python3 chip_smoke.py --alone 17                  # phase 17
    python3 chip_smoke.py --alone 18                  # phase 18
    python3 chip_smoke.py --alone 19                  # phase 19
    python3 chip_smoke.py --alone 20                  # phase 20

Phases (each prints its own lines; any failure exits non-zero):
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — builds the hand-written kernels from csrc/ with nvcc, one
               process per source, all started together;
  3. K1      — the fused LN-attention sublayer against its plain version on
               the card at the serving path's, the train step's and the
               long-token trainer's shapes (vision, text, temporal), with
               each shape's share of the bound;
  4. K2      — the similarity kernel against its plain version at
               Q = 64, 8 and 1 queries against N=10,000 videos (T=24, V=12,
               D=512), each timed beside its bound as SIMT fp32 and as
               3xTF32 (the kernel's arithmetic) and its share of both;
  5. serving — indexes a 64-video synthetic corpus (one index batch) with
               the full-width ViT-B/32 model (seeded random weights, bf16)
               and answers three requests of 1, 8 and 64 queries through a
               Searcher; checks the kernels' launch counts in that run,
               that all scores are finite, and that they match a run of the
               plain versions on the card;
  6. K3      — the sublayer's backward kernel against its plain backward at
               the train step's and the long-token trainer's shapes, every
               output, run twice to show bit-equal results, with each
               shape's share of the bound;
  7. K4, K5  — the bank-centrality mean and the similarity backward against
               their plain versions at the train step's two shapes,
               (128, 24, 1920, 12, 512) over axis 1 and (1920, 24, 128, 12,
               512) over axis 0, with ragged masks: K4 with and without
               its residual stores (bit-equal), K5 from those residuals
               against the plain routed backward, each side alone against
               both (bit-equal), run twice; on exact logits the saved
               routing against the plain first argmax; timed in the train
               step's form (one side) and with both; K4's time beside both
               bounds (SIMT fp32, 3xTF32);
  8. train   — full-width model, batch 128, memory bank 15 x 128 = 1920:
               bank fill, then 3 optimizer steps on distinct batches through
               the kernels; checks launch counts, finite losses, that
               parameters moved and the frozen patch embedding did not, and
               the bank's fresh rows; then the same from the same state
               through the plain versions on the card, given the kernel
               run's cluster ids and neighbour masks and, for the last
               step, the state its last step started from: losses, gradient
               norms and parameter updates compared.  --profile adds one
               profiled step (device time by kernel), here and in phases
               10, 12 and 13;
  9. K6, K7  — the blocked long-token similarity and its backward against
               their plain versions at (128, 64, 1920, 64, 512) and (1920,
               64, 128, 64, 512): real-valued features with ragged masks
               and duplicated tokens through the wrapper (both feature
               sides, then the train step's one), K7 from K6's residuals
               against the plain routed backward, each side alone against
               both (bit-equal), run twice; inputs whose logits are exact
               in fp32 for the saved routing against the plain first
               argmax and the elementwise check of all four gradients;
               K7 from K6's routing against the plain routed backward fed
               float64's first argmax (and the count of K6's indices off
               it) beside the check against cuBLAS's routing; K6
               timed with and without its residual stores beside both
               bounds (SIMT fp32, its route, and 3xTF32), K7 in the train
               step's form and with both sides; the forward also timed at
               an eval shape;
 10. trainer — `neighborretr_tpu_torch.cli.train` at the reference's
               ActivityNet/DiDeMo recipe widths (64 words, 64 frames, batch
               128, bank 1920, 8 micro-batches, bf16, depth not cut) on
               synthetic data: bank fill and two steps, SIGTERM, a second
               call that resumes from state_preempt.npz and takes the third
               step, evaluates, saves and tests the best weights; launch
               counts of all seven kernels, finite losses, R@K, the files
               read back; then the same three steps in one run through
               the plain versions (cluster ids and neighbour masks
               replayed, the last step taken from the kernel runs'
               state_preempt.npz): losses, gradient norms and updates
               compared.
 11. K8, K9  — the packed-qkv attention kernel and its backward against
               their plain versions at every tower's shape: ViT-B/32 vision
               (N=1536, L=50), text (L=24, 64, causal∧padding bias), temporal
               (L=12, 64, key-padding bias), ViT-B/16 (L=197) and
               ViT-L/14@336px (L=577, 16 heads); out, lse and all of dqkv,
               K9 fed the forward's out and lse as the autograd node feeds
               it, and run twice; `scaled_dot_product_attention` and its
               backward timed beside them as the library's yardstick (the
               port never calls it), with TFLOP/s and the share of the
               bound;
 12. fused   — phases 5 and 8 again with attention_impl="fused": every
               attention sublayer through K8/K9 and none through K1/K3; the
               train run held to a run with only K8/K9 swapped for their
               plain version;
 13. ViT-L   — ViT-L/14@336px at full depth (24 x 1024 vision at 577 tokens,
               12 x 768 text, seeded random weights, attention_impl="auto":
               the vision tower lands on K8/K9, text and temporal on K1/K3):
               cli/index.py + cli/search.py on 16 synthetic videos, then
               train steps at batch 16, bank 240 under remat "full" (2
               steps), remat "attn" and video_chunk_frames=48 (1 step each,
               from the same state): launch counts, peak memory and step-1
               loss per setting; the CLIs and one step at ViT-B/16 too.
 14. K10, K11 — the sublayer without LayerNorm and residual and its
               backward (`fused_attention_sublayer`, which no model path
               calls, as in the JAX package): its kernel check first, the
               counterpart of scripts/pallas_tpu_check.py's block check
               (N=768, L=50, H=12: forward and backward through the public
               function, each weight gradient within 5% of the fp32 plain
               composition), then both kernels against their plain versions
               at that shape, the train step's vision shape (N=1536) and the
               text and temporal shapes with their biases, K11 twice;
               `nn.MultiheadAttention` timed beside them as the library's
               yardstick (the port never calls it), each shape's share of
               the bound and kernel / library; then at phase 19's tensor-
               parallel shapes, a rank's half of the heads (its rows of q,
               k and v, its columns of W_o), where no library call computes
               the function;
 15. augment — the device RandAugment: (a) on the card against the CPU on
               one structured batch of 8 x 12 x 224² with draws fixed so
               that each of the 16 ops fires; (b) its time and peak memory
               on a flagship batch of 128 x 12 x 224² under
               rand-m7-n4-mstd0.5-inc1; (c) `cli.train --augment_backend
               device` at the MSR-VTT recipe widths (ViT-B/32, 24 words x 12
               frames, batch 128, bank 15 x 128 cut by the data's length to
               3 x 128, bf16): bank fill, 3 steps, eval; launch counts,
               finite losses, R@K, every augmented batch changed.
 16. daemon  — the rest of serving at ViT-B/32 width (bf16, seeded random
               weights saved once as an npz checkpoint): (a) cli.index on
               256 synthetic videos, cli.serve --port 0 on it (healthz, a
               search), cli.index --append of 64 more (256 skipped), POST
               /reload (320 videos), SIGINT exit 0, cli.export_checkpoint
               (the reference's keys, read back with torch.load) and
               cli.export (a bundle); (b) make_server in this process over
               a 10,000-row index of random features, fp16 then int8, lock-
               serialised then behind the BatchingDispatcher (2 ms window,
               64 merged queries, buckets of 8): 64 concurrent single-query
               clients, 3 rounds: queries/s, p50/p95/p99, device calls per
               request; K1 = 12 x device calls, K2 = device calls; every
               response against Searcher.search of its query alone; one
               round with a staged /reload (512-row slabs) mid-round; (c)
               the bundle loaded in a process that can import neither
               package, against Searcher(kernels=False) and the kernels.
 17. data parallel — torch.distributed at ViT-B/32 width (bf16, depth not
               cut, seeded random weights, synthetic data): (a) cli.train
               --num_devices 1 at the MSR-VTT recipe (batch 128, bank 15 x
               128 filled by the data's length to 2 x 128, 2 steps, eval)
               through a one-rank NCCL group: launch counts, ms per step
               and peak memory beside phase 8's; (b) two ranks on the one
               card (two processes over gloo with the tensors on the card:
               NCCL takes one rank a device), global batch 128 = 2 x 64,
               bank 15 x 128, bank fill and 2 steps in the gathered form,
               then in the explicit row-sharded form (K2/K5 on the bank
               rows), each against one process over the same batches with
               its DPC-KNN clusters and top-k masks replayed: loss terms,
               gradient norms, moments, every parameter's update, the bank;
               the ranks' parameters bit-equal; (c) the long recipe's
               explicit form (64 words x 64 frames, batch 32 = 2 x 16, bank
               15 x 32, 1 step; K6/K7) the same way; (d) a Searcher over
               10,000 videos in two shards on [cuda:0, cuda:0] against one
               shard: top-5 ids and scores, K2 once a shard.  Two ranks on
               one card measure no scale-out.
 18. real inputs — the input side at ViT-B/32 width (bf16, depth not cut):
               a seeded random ViT-B/32 in OpenAI's layout (TorchScript,
               fp16) as --clip_checkpoint; 64 train videos x 2 captions and
               16 test videos in MSR-VTT's layout, clips of 12 s at 320 x 240
               written with cv2; cli.pack_dataset; cli.train (1 epoch, batch
               32, bank 2 x 32, 12 frames x 24 words, the native host
               augment) on the packs: model.clip at step 1 equal to the
               archive, the temporal tower seeded from its text tower,
               launch counts, finite losses and R@K, step 1 against the
               plain versions from the same state (cluster ids and
               neighbour masks replayed); the same epoch decoding the clips
               (loader wait and ms/step against the packs); cli.eval from
               best.npz and from the best.pth cli.export_checkpoint writes
               of it (equal R@K); cli.index of the test split and a
               cli.search query, with launch counts.
 19. sharded — the model-sharded strategies at ViT-B/32 width (bf16,
               depth not cut, seeded random weights) at the MSR-VTT
               recipe's widths (24 words x 12 frames), only the data cut
               (global batch 32, bank 2 x 32, 2 steps a strategy), as gloo
               ranks sharing the one card: (a) tensor parallelism, data 1 x
               model 2, on the block route (K10/K11 on each rank's heads),
               then one step on the fused route (K8/K9 on H/2 heads) from
               the same initial state; (b)
               FSDP2 over 2 ranks; (c) the pipeline, stage 2 x 4
               microbatches (K1/K3 per stage); (d) pipeline x tensor, 1 x 2
               x 2 (four processes); each against one process over the same
               global batches with its DPC-KNN clusters and top-k masks
               replayed (phase 17's comparison, at phase 17's bars for (b)
               and (c) and at bars from the bf16 rounding of the partial
               sums for (a) and (d)), the replicated parameters bit-equal
               across the ranks; ms/step (ranks sharing one card, not
               scale-out), peak memory and parameter + moment bytes a rank
               beside one process's (FSDP at most 0.55 x), launches; (e)
               cli.eval --tensor_parallel 2 on 16 videos against one
               process's similarity matrix.
 20. host memory — the trainer's host-memory paths at the MSR-VTT recipe
               (ViT-B/32 width, bf16, seeded random weights): (a) one
               flagship batch's upload, `to_device` from pageable memory
               against the prefetch's pinned slot and copy stream; (b) the
               bank fill and 3 steps from equal state under the four
               placements of the bank and the moments (device/device, host
               moments, host bank, both), torch's deterministic algorithms
               on and device/device's decisions replayed: loss terms,
               parameters, moments and bank bit-equal to device/device,
               peak memory, ms/step and K1/K3/K4/K5 launches per
               placement; (c) cli.train through the prefetch (5 fills, 5
               steps, eval), then with the loop's batches moved by
               to_device (the loop before the prefetch), then through the
               prefetch again: ms/step, step to step, data_wait_s; (d)
               cli.train --debug_nans with a NaN planted before step 2: a
               FloatingPointError that names the parameter, the clean
               step's ms; (e) the learning check (tools/learning_check.py)
               with the prefetch, host moments and host bank on: R@1 >= 75
               both ways.
The line before the last is a JSON object with, for each kernel, its
launches on each main path (all eleven counts are set to 0 before each path
and read after it; phase 16's path is its in-process load, (b)), error, times and roofline bound; the last line is the
device record.

Imports only torch, numpy and the port (no JAX).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
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
# K3's fp32 sums over all rows (weight and bias gradients): a bf16 operand
# that flips by one ulp, where differently ordered fp32 sums straddle a
# rounding boundary, moves single terms by 2^-8 of their size; the bound is
# relative to the tensor's largest entry, not elementwise
K3_SUM_TOL = 2 ** -7
# kernel train run vs plain train run on the card.  The plain run is given
# the kernel run's discrete decisions (DPC-KNN cluster ids, the neighbor
# loss's top-k masks): they are taken on bf16 features, a one-ulp difference
# flips some of them, and a run with other cluster ids is another function
# of the weights, not a noisier copy of the same one (at step 2 of this very
# run 44 text-token assignments in 10 captions move the gradient norm by 5%;
# with them replayed it agrees to 0.2%: scripts/torch_step_gap.py).  Loss
# terms: bf16 towers of 12 + 4 layers whose one-ulp flips carry into the
# features (observed at most 1.4e-3 on an H100).  Gradient norm: every
# step of both runs is taken at bit-identical weights, moments and bank:
# steps 1 and 2 because the schedule's first update is zero (observed at
# most 5.1e-3), step 3 because the plain run takes it from the state the
# kernel run's step 3 started from (observed 3.7e-4 and 3.1e-3; that state
# differs from run to run).  Left to run free the two part there
# by what a run differs from its own repeat, not by what the kernels do
# (torch's float-atomic scatter-adds move a gradient by 0.4%, same script;
# observed 1.4e-3 ... 1.1e-2 of step 3's norm in ten runs of this script).
# Parameter updates: Adam divides by sqrt(v), so where a gradient entry is
# near zero its noise is as large as the update; they are held as a
# relative L2 distance over the whole tensor (observed at most 0.038;
# 0.077 while the two runs ran free)
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_NORM_RTOL = (1e-2, 3e-2)      # steps 1-2, step 3
TRAIN_UPDATE_REL_L2 = 0.15
# The long-token trainer's kernel runs against reference runs of the same
# three steps: loss terms, gradient norm and the updates' relative L2.
# Every step of both is taken at bit-identical weights, moments and bank:
# steps 1 and 2 because the schedule's first update is zero, step 3 because
# the reference run takes it from the kernel runs' own state_preempt.npz.
# Left to run free, two runs part at step 3 by what one run differs from its
# own repeat: torch's float-atomic scatter-adds move step 2's gradient by
# 0.6-0.8% (1.5e-4 and 2.8e-4 of its norm; scripts/torch_step_gap.py --long
# --batch 128 --micro_batches 8 on an H100), Adam's m / sqrt(v) turns that
# into up to 5% of an update, and the uniform loss's Sinkhorn on 128 x 128
# unnormalised logits into 2e-4 ... 1.1e-2 of step 3's loss in seven runs of
# this script, which says nothing about a kernel.
# KP: K1/K3 in the towers, the plain blocked similarity.  The same features
# reach K6/K7 and their plain version, so the losses differ by K6's
# rounding only (its 3xTF32 logits against cuBLAS's fp32 ones: observed at
# most 1.2e-7, and step 3's total loss bit-equal) and the gradients by the
# repeat's noise (norms: at most 1.9e-4; updates: at most 7.7e-3).
KP_TOL = ((1e-4, 1e-4, 1e-4), (3e-3, 3e-3, 3e-3), 0.05)
# PLAIN: the plain versions of everything, cluster ids and neighbour masks
# replayed.  At this shape replaying them leaves more than at 24 words x 12
# frames: the same script finds the plain gradient 0.014 (step 1) and 0.126
# (step 2) away from the kernels' as a whole and 0.8% / 2.1% in norm, with
# K6/K7 cleared (swapping only them for their plain version stays inside
# the repeat's noise) and the similarity's winners shown not to matter
# (replaying them changes nothing): the towers' bf16 rounding, amplified by
# the uniform loss's Sinkhorn on 128 x 128 unnormalised logits at random
# weights.  Observed in this script: norms 1.5% / 4.0% / 0.06%, losses
# 1.9e-3 and 4.4e-3 at steps 1 and 2 (the same in every run) and 1.1e-3 and
# 5.3e-3 at step 3, whose weights are the kernel run's and differ from run to
# run; updates up to 0.012.
LONG_PLAIN_TOL = ((1e-2, 1e-2, 4e-2), (8e-2, 8e-2, 8e-2), 0.15)
# K7's feature gradients on real-valued inputs against the plain version,
# which routes by cuBLAS's fp32 logits, as a whole tensor: where a max's
# runner-up lies within cuBLAS's rounding (its maxima lie up to 3.5e-7 from
# float64) the plain version may route its gradient to another token than
# float64's first argmax, which K6's routing is (its near-ties re-picked in
# float64, ops/similarity.py::resolve_near_ties); one such row of the 31
# million maxima at the bank shapes moves the distance by ~4e-4.  Observed
# on an H100: 2.5e-4 .. 9.1e-4 in this script, 1.02e-3 when phase 9 ran
# alone on its own draws (before the re-pick).  On inputs with exact
# logits all four gradients are held elementwise.
K7_REAL_REL_L2 = 1e-3
# K7 on K6's routing against the plain routed backward fed float64's first
# argmax of the same prepared inputs (both sides, relative L2 of the feature
# gradients): with the same routing only the fp32 summation order differs
# (~1e-7); a few maxima routed to other tokens move it by ~1e-4 (9e-5
# with 2 of 15.7 million text-side indices off float64's, before K6
# re-picked near-ties in float64; H100)
K7_F64_REL_L2 = 1e-5
# K5/K7 with one feature side asked for launch one of the two gathers: at
# the train step's shapes a side takes 0.5-0.65 of the both-side time
ONE_SIDE_SHARE = 0.85

# NVIDIA's data sheet for the H100 SXM: dense bf16 tensor-core rate, fp32
# rate outside the tensor cores, device memory rate; the dense TF32
# tensor-core rate (the sheet's 989 is with sparsity)
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_TF32 = 494.7e12


def bound(flops: float, peak: float, nbytes: float):
    """(ms, which): the least time the card could take — the larger of the
    operations over their peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sim_bounds(flops: float, nb: float):
    """The two bounds of a similarity forward of `flops` FLOP (2·A·T·B·V·D)
    moving `nb` bytes: (SIMT fp32 ms, which, 3xTF32 ms, which) — fp32 FMAs
    outside the tensor cores, or three TF32 products a logit on them (the
    3xTF32 split)."""
    return (*bound(flops, PEAK_FP32, nb), *bound(3 * flops, PEAK_TF32, nb))


def bound_shares(ms: float, b: tuple) -> str:
    return (f"bound {b[0]:.4f} ms ({b[1]}) as SIMT fp32, {100 * b[0] / ms:.1f}%"
            f" of it; {b[2]:.4f} ms ({b[3]}) as 3xTF32, "
            f"{100 * b[2] / ms:.1f}% of it")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


LIBS = ("frame_attention", "interaction_similarity",
        "interaction_similarity_blocked", "ln_attention_residual",
        "ln_attention_residual_bwd")


def kernel_wrappers():
    """The eleven wrappers by kernel; each counts its launches in
    `.launches`."""
    from neighborretr_tpu_torch.ops import attention as A
    from neighborretr_tpu_torch.ops import block_attention as BA
    from neighborretr_tpu_torch.ops import similarity as S
    from neighborretr_tpu_torch.ops import similarity_blocked as SB
    return {"K1": BA.ln_attention_residual,
            "K2": S.fused_interaction_similarity,
            "K3": BA.ln_attention_residual_bwd,
            "K4": S.fused_interaction_mean, "K5": S.fused_similarity_bwd,
            "K6": SB.fused_interaction_similarity_blocked,
            "K7": SB.fused_blocked_similarity_bwd,
            "K8": A.frame_attention, "K9": A.frame_attention_bwd,
            "K10": BA.attention_sublayer, "K11": BA.attention_sublayer_bwd}


def counted(fn):
    """Sets every kernel's count to 0, runs `fn`, reads the counts straight
    after → (fn's result, launches by kernel)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


def phase_build():
    print("== phase 2: build")
    from neighborretr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load(*LIBS)
    print(f"  built in {time.perf_counter() - t0:.2f} s into {_build.build_dir()}")
    for name in LIBS:
        log = _build.compiler_log(name)
        regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
        # per kernel: its (mangled) name, then its spill line
        spilling = []
        for entry in log.split("Compiling entry function '")[1:]:
            kernel = entry.split("'")[0]
            if any("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                   "loads" not in ln for ln in entry.splitlines()):
                short = re.search(r"\d+([a-z_]+_kernel)(I.*?E)?E", kernel)
                spilling.append(short.group(1) + (short.group(2) or "")
                                if short else kernel)
        serialized = sorted({ln.split("(")[1].split(")")[0]
                             for ln in log.splitlines() if "(C75" in ln})
        print(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)}"
              f" registers/thread, {len(spilling)} with register spills"
              f"{' (' + ', '.join(spilling) + ')' if spilling else ''}, "
              f"wgmma serialization notes: {serialized or 'none'}")


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
    # the serving run's shapes (a 64-video index batch, 64 queries), one
    # train step's at batch 128, then the long-token trainer's: 64 words,
    # 64 frames, the vision tower on one micro-batch of 16 videos
    shapes = [("vision", 768, 50, 768, 12, None),
              ("text", 64, 24, 512, 8, "causal"),
              ("temporal", 64, 12, 512, 8, "keypad"),
              ("vision train", 1536, 50, 768, 12, None),
              ("text train", 128, 24, 512, 8, "causal"),
              ("temporal train", 128, 12, 512, 8, "keypad"),
              ("vision long", 1024, 50, 768, 12, None),
              ("text long", 128, 64, 512, 8, "causal"),
              ("temporal long", 128, 64, 512, 8, "keypad")]
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
        M = N * L
        b_ms, b_by = bound(8 * M * D * D + 4 * N * L * L * D, PEAK_BF16,
                           nbytes(*args, bias, got))
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of the "
              "bound")
        rows[name] = (err, ms, plain_ms, b_ms, b_by)
    return rows


def phase_k2(g):
    """K2 against its plain version at serving's three request sizes; the
    64-query request is the one the JSON line reports (the rows of the
    others go beside it)."""
    print("== phase 4: K2 interaction_similarity vs its plain version")
    from neighborretr_tpu_torch.ops import similarity as S
    from neighborretr_tpu_torch.ops.similarity import (
        fused_interaction_similarity, interaction_similarity)
    T, N, V, D = 24, 10_000, 12, 512
    dev = "cuda"
    vf = torch.randn(N, V, D, generator=g, device=dev)
    vlen = torch.randint(1, V + 1, (N,), generator=g, device=dev)
    vm = (torch.arange(V, device=dev)[None] < vlen[:, None]).float()
    vw = torch.softmax(torch.randn(N, V, generator=g, device=dev)
                       .masked_fill(vm == 0, -9e15), -1)
    rows = {}
    for Q in (64, 8, 1):
        tf = torch.randn(Q, T, D, generator=g, device=dev)
        tlen = torch.randint(2, T + 1, (Q,), generator=g, device=dev)
        tm = (torch.arange(T, device=dev)[None] < tlen[:, None]).float()
        tw = torch.softmax(torch.randn(Q, T, generator=g, device=dev)
                           .masked_fill(tm == 0, -9e15), -1)
        args = (tf, vf, tm, vm, tw, vw)
        got = fused_interaction_similarity(*args)
        torch.cuda.synchronize()
        want = interaction_similarity(*args)
        err = compare(f"Q={Q} T={T} N={N} V={V} D={D}", got, want, K2_TOL)
        ms = time_ms(lambda: fused_interaction_similarity(*args), 10)
        plain_ms = time_ms(lambda: interaction_similarity(*args), 5)
        b = sim_bounds(2 * Q * T * N * V * D, nbytes(*args, got))
        print(f"  Q={Q}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              + bound_shares(ms, b))
        rows[f"Q={Q}"] = (err, ms, plain_ms, b[2], b[3], None, b[0])
        if Q == 64:
            # under autograd the kernel also stores the backward's routing:
            # the same S to the bit, timed on the prepared inputs both ways
            prep = S._prepare(*args, True)
            if not torch.equal(S._similarity_fwd(*prep, save=True)[0],
                               S._similarity_fwd(*prep)[0]):
                raise SystemExit("K2: the forward with its residual stores "
                                 "differs from the one without")
            bare_ms = time_ms(lambda: S._similarity_fwd(*prep), 10)
            save_ms = time_ms(lambda: S._similarity_fwd(*prep, save=True), 10)
            print(f"  on prepared inputs: {bare_ms:.4f} ms, with the residual"
                  f" stores (under autograd) {save_ms:.4f} ms, bit-equal")
            del prep
        del want
    return rows


def phase_serving(attention_impl="auto"):
    """attention_impl "auto": phase 5, the sublayer kernel's route (K1).
    "fused": the same run on the attention kernel's route (K8), part of
    phase 12."""
    fused = attention_impl == "fused"
    print(f"== phase {'12a' if fused else '5'}: serving run (ViT-B/32 width, "
          f"bf16, random weights, attention_impl={attention_impl!r})")
    import dataclasses as dc

    from neighborretr_tpu_torch.core.config import Config, ModelConfig
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        SyntheticDataset
    from neighborretr_tpu_torch.data.loader import BatchLoader
    from neighborretr_tpu_torch.data.tokenizer import ClipTokenizer
    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.eval import (encode_video_batch,
                                             similarity_matrix_device)
    from neighborretr_tpu_torch.models.weights_io import init_model

    cfg = Config(model=dc.replace(ModelConfig(),
                                  attention_impl=attention_impl))
    m = cfg.model
    print(f"  model: {m.clip.vision_layers}x{m.clip.vision_width} vision "
          f"(patch {m.clip.vision_patch_size}, {m.clip.image_resolution}px), "
          f"{m.clip.transformer_layers}x{m.clip.transformer_width} text, "
          f"{m.temporal_layers} temporal, {m.max_frames} frames, "
          f"{m.max_words} words, {m.compute_dtype}")
    model = init_model(m, seed=0, device="cuda")
    n_videos, batch = 64, 64
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

    def serve():
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
        return index, t_index, searcher, hits, latencies

    (index, t_index, searcher, hits, latencies), counts = counted(serve)

    n_batches = -(-n_videos // batch)
    fwd = "K8" if fused else "K1"     # the route's forward attention kernel
    want = dict.fromkeys(kernel_wrappers(), 0)
    want[fwd] = (n_batches * (m.clip.vision_layers + m.temporal_layers)
                 + len(requests) * m.clip.transformer_layers)
    want["K2"] = len(requests)
    print(f"  launches in the serving run: {counts} (expected {want}: per "
          f"index batch {fwd} = {m.clip.vision_layers + m.temporal_layers}, "
          f"per request {fwd} = {m.clip.transformer_layers} and K2 = 1; no "
          "backward and no bank mean)")
    if counts != want:
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
    return counts, err


def phase_k3(g):
    print("== phase 6: K3 ln_attention_residual_bwd vs its plain backward")
    from neighborretr_tpu_torch.ops.block_attention import (
        ln_attention_residual_bwd, ln_attention_residual_bwd_plain)
    # one train step's shapes at batch 128 (1536 frames, 128 captions and
    # videos), then the long-token trainer's (64 words, 64 frames, the
    # vision tower on one micro-batch of 16 videos)
    shapes = [("vision", 1536, 50, 768, 12, None),
              ("text", 128, 24, 512, 8, "causal"),
              ("temporal", 128, 12, 512, 8, "keypad"),
              ("vision long", 1024, 50, 768, 12, None),
              ("text long", 128, 64, 512, 8, "causal"),
              ("temporal long", 128, 64, 512, 8, "keypad")]
    names = ("dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_out", "db_out")
    rows = {}
    for name, N, L, D, H, kind in shapes:
        args, bias = _attn_inputs(g, N, L, D, kind)
        dy = torch.randn(N, L, D, generator=g, device="cuda").bfloat16()
        got = ln_attention_residual_bwd(*args, H, dy, bias)
        torch.cuda.synchronize()
        want = ln_attention_residual_bwd_plain(*args, H, dy, bias)
        tag = f"{name} N={N} L={L} D={D} H={H}"
        err = compare(f"{tag} dx", got[0], want[0], K1_TOL)
        for out_name, a, b in zip(names, got[1:], want[1:]):
            scale = b.abs().max().item()
            e = (a - b).abs().max().item()
            ok = bool(torch.isfinite(a).all()) and e <= K3_SUM_TOL * scale
            print(f"  {tag} {out_name}: max_abs_err {e:.6g} against max "
                  f"|plain| {scale:.6g} (tolerance {K3_SUM_TOL:g}·max|plain|)"
                  f" {'ok' if ok else 'FAILED'}")
            if not ok:
                raise SystemExit(f"K3 {out_name} disagrees with its plain "
                                 "version")
            err = max(err, e)
        again = ln_attention_residual_bwd(*args, H, dy, bias)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit("K3: two runs differ in their bits")
        print(f"  {tag}: two runs bit-equal in all 7 outputs")
        ms = time_ms(lambda: ln_attention_residual_bwd(*args, H, dy, bias), 10)
        plain_ms = time_ms(
            lambda: ln_attention_residual_bwd_plain(*args, H, dy, bias), 3)
        M = N * L
        b_ms, b_by = bound(22 * M * D * D + 12 * N * L * L * D, PEAK_BF16,
                           nbytes(*args, bias, dy, *got))
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of the "
              "bound")
        rows[name] = (err, ms, plain_ms, b_ms, b_by)
    return rows


def routed_bound(tw, vw, D, sides, *tensors):
    """(ms, which, live share) of a backward from the routing, from the
    tokens these inputs weight: a token of weight 0 (masked) adds exact
    zeros and needs no work, so per feature side asked for 2·D FLOP for
    each live token of each pair, 2·D·(B·ΣT_live + A·ΣV_live) (each routed
    row multiplied by its coefficient and added; the weights' gradients,
    D times fewer, left out); the bytes of its inputs and outputs.  The
    live share is that count over the dense 2·A·B·(T+V)·D."""
    (A, T), (B, V) = tw.shape, vw.shape
    live = B * int((tw != 0).sum()) + A * int((vw != 0).sum())
    return (*bound(2 * live * D * sides, PEAK_FP32, nbytes(*tensors)),
            live / (A * B * (T + V)))


def check_routed_bwd(tag, bwd, plain_bwd, prep, cot, res, need):
    """One backward kernel from the forward's residuals against the plain
    routed backward on the same residuals (elementwise), each side alone
    against the both-side call's bits, two runs bit-equal → (worst error,
    the outputs of the call in the train step's form)."""
    names = ("dtn", "dvn", "dtw", "dvw")
    both = bwd(*prep, cot, *res)
    torch.cuda.synchronize()
    want = plain_bwd(*prep, cot, *res)
    err = max(compare(f"{tag} {n}", a, b, K2_TOL)
              for n, a, b in zip(names, both, want))
    text = bwd(*prep, cot, *res, need_v=False)
    video = bwd(*prep, cot, *res, need_t=False)
    if text[1] is not None or video[0] is not None:
        raise SystemExit(f"{tag}: a side not asked for was computed")
    if not (torch.equal(text[0], both[0]) and torch.equal(video[1], both[1])
            and all(torch.equal(o[k], both[k]) for o in (text, video)
                    for k in (2, 3))):
        raise SystemExit(f"{tag}: a one-side call differs from the "
                         "both-side call's bits")
    again = bwd(*prep, cot, *res)
    if not all(torch.equal(a, b) for a, b in zip(both, again)):
        raise SystemExit(f"{tag}: two runs differ in their bits")
    # a side not asked for is not computed: each one-side call takes well
    # under the both-side call's time (one gather of two; device time)
    ms = [time_ms(lambda: bwd(*prep, cot, *res, **side), 5)
          for side in (dict(need_v=False), dict(need_t=False), {})]
    if max(ms[:2]) > ONE_SIDE_SHARE * ms[2]:
        raise SystemExit(f"{tag}: a one-side call takes {max(ms[:2]):.4f} "
                         f"ms against both sides' {ms[2]:.4f}")
    print(f"  {tag}: each side alone bit-equal to the both-side call; two "
          f"runs bit-equal; text / video / both sides {ms[0]:.4f} / "
          f"{ms[1]:.4f} / {ms[2]:.4f} ms")
    return err, (text if need == "text" else video)


def phase_k4_k5(g):
    print("== phase 7: K4 interaction_mean, K5 interaction_similarity_bwd vs "
          "their plain versions")
    from neighborretr_tpu_torch.ops import similarity as S
    dev = "cuda"
    k4, k5 = {}, {}
    # the train step's two bank centralities: cent_t differentiates the
    # captions (the bank's videos are detached), cent_v the videos
    for A, T, B, V, D, axis in ((128, 24, 1920, 12, 512, 1),
                                (1920, 24, 128, 12, 512, 0)):
        need = "text" if axis == 1 else "video"
        tf = torch.randn(A, T, D, generator=g, device=dev)
        vf = torch.randn(B, V, D, generator=g, device=dev)
        tlen = torch.randint(4, T + 1, (A,), generator=g, device=dev)
        vlen = torch.randint(1, V + 1, (B,), generator=g, device=dev)
        tm = (torch.arange(T, device=dev)[None] < tlen[:, None]).float()
        vm = (torch.arange(V, device=dev)[None] < vlen[:, None]).float()
        tw = torch.softmax(torch.randn(A, T, generator=g, device=dev)
                           .masked_fill(tm == 0, -9e15), -1)
        vw = torch.softmax(torch.randn(B, V, generator=g, device=dev)
                           .masked_fill(vm == 0, -9e15), -1)
        args = (tf, vf, tm, vm, tw, vw)
        tag = f"A={A} T={T} B={B} V={V} D={D} axis={axis}"
        flops = 2 * A * T * B * V * D

        got = S.fused_interaction_mean(*args, axis=axis)
        torch.cuda.synchronize()
        err = compare(f"K4 {tag}", got, S.interaction_mean(*args, axis=axis),
                      K2_TOL)
        prep = S._prepare(*args, True)
        saved, res = S._mean_fwd(*prep, axis, save=True)
        torch.cuda.synchronize()
        if not torch.equal(saved, got):
            raise SystemExit("K4: the forward with its residual stores "
                             "differs from the one without")
        print(f"  K4 {tag}: with the residual stores (under autograd) "
              "bit-equal to without")
        ms = time_ms(lambda: S.fused_interaction_mean(*args, axis=axis), 10)
        bare_ms = time_ms(lambda: S._mean_fwd(*prep, axis), 10)
        save_ms = time_ms(lambda: S._mean_fwd(*prep, axis, save=True), 10)
        plain_ms = time_ms(lambda: S.interaction_mean(*args, axis=axis), 5)
        b = sim_bounds(flops, nbytes(*args, got))
        b_save = sim_bounds(flops, nbytes(*args, got, *res))
        print(f"  K4 axis={axis}: kernel {ms:.4f} ms (wrapper), plain "
              f"{plain_ms:.4f} ms, " + bound_shares(ms, b))
        print(f"  K4 axis={axis} on prepared inputs: {bare_ms:.4f} ms; with "
              f"the residual stores (under autograd, the train step's form) "
              f"{save_ms:.4f} ms, " + bound_shares(save_ms, b_save))
        k4[axis] = (err, ms, plain_ms, b[2], b[3], None, b[0])
        k4[f"{axis} saving"] = (err, save_ms, plain_ms, b_save[2], b_save[3],
                                None, b_save[0])

        # the cotangent the train step hands down: a mean's, spread over
        # the reduced axis
        n_red = B if axis == 1 else A
        cot = torch.randn(A if axis == 1 else B, generator=g, device=dev)
        gmat = ((cot / n_red)[:, None] if axis == 1
                else (cot / n_red)[None, :]).expand(A, B).contiguous()
        err, out = check_routed_bwd(f"K5 {tag}", S.fused_similarity_bwd,
                                    S.similarity_bwd_routed_plain, prep,
                                    gmat, res, need)
        # exact logits: the saved routing is the plain first argmax, ties
        # included, and the backward the plain one with its own routing
        ex = _blocked_inputs(g, A, T, B, V, D, exact=True)
        _, ex_res = S._similarity_fwd(*ex, save=True)
        _, want_res = S.similarity_routing_plain(*ex)
        if not all(torch.equal(a[..., :n], b) for a, b, n in
                   zip(ex_res, want_res, (T, T, V, V))):
            raise SystemExit("K2/K4's saved routing differs from the plain "
                             "first argmax")
        print(f"  K5 {tag}: saved routing equal to the plain first argmax "
              "(exact logits)")
        err = max(err, *(compare(f"K5 {tag} {n} (exact logits)", a, b,
                                 K2_TOL)
                         for n, a, b in zip(
                             ("dtn", "dvn", "dtw", "dvw"),
                             S.fused_similarity_bwd(*ex, gmat, *ex_res),
                             S.similarity_bwd_plain(*ex, gmat))))
        del ex, ex_res, want_res
        side = dict(need_t=need == "text", need_v=need == "video")
        ms = time_ms(lambda: S.fused_similarity_bwd(*prep, gmat, *res,
                                                    **side), 10)
        both_ms = time_ms(lambda: S.fused_similarity_bwd(*prep, gmat, *res),
                          10)
        plain_ms = time_ms(lambda: S.similarity_bwd_routed_plain(
            *prep, gmat, *res, **side), 3)
        outs = [o for o in out if o is not None]
        b_ms, b_by, live = routed_bound(prep[2], prep[3], D, 1, *prep, gmat,
                                        *res, *outs)
        both_b = routed_bound(prep[2], prep[3], D, 2, *prep, gmat, *res,
                              *prep)[:2]
        print(f"  K5 axis={axis} ({need} side, the train step's form): "
              f"kernel {ms:.4f} ms, both sides {both_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; live tokens "
              f"{100 * live:.1f}% of the slots), {100 * b_ms / ms:.1f}% of "
              f"the bound; both sides' bound {both_b[0]:.4f} ms")
        k5[axis] = (err, ms, plain_ms, b_ms, b_by)
        k5[f"{axis} both sides"] = (err, both_ms, plain_ms, *both_b)
    return k4, k5


# parameters whose updates the kernel run and the plain run are compared on:
# one of each kind the backward kernels feed (attention weights of all three
# towers, an MLP behind them, embeddings, the similarity's weight nets, the
# merge stacks).  Left out: tensors whose entries are near 1 in the CLIP
# branch (LayerNorm scales, the logit scale), where one step at that
# branch's learning rate of 1e-7 is below half an fp32 ulp
TRAIN_COMPARED = (
    "clip.visual.transformer.resblocks.0.attn.in_proj_weight",
    "clip.visual.transformer.resblocks.11.attn.out_proj.weight",
    "clip.visual.transformer.resblocks.5.mlp.c_fc.weight",
    "clip.visual.class_embedding",
    "clip.transformer.resblocks.0.attn.in_proj_weight",
    "clip.transformer.resblocks.11.mlp.c_proj.weight",
    "clip.text_projection",
    "transformerClip.resblocks.0.attn.in_proj_weight",
    "transformerClip.resblocks.3.attn.out_proj.bias",
    "frame_position_embeddings.weight",
    "text_weight_fc.0.weight", "video_weight_fc.2.weight",
    "text_ctm0.score.weight", "video_block0.attn.kv.weight")
LOSS_TERMS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
              "kl_loss")


@contextlib.contextmanager
def decisions(log: list, replay=None, routing=None, replay_routing=None):
    """Records every discrete decision of one forward into `log` (the four
    DPC-KNN cluster assignments, then the neighbor loss's two top-k masks),
    or hands back the ones in `replay` instead of taking them (a None there
    is taken anew).  routing: a dict that receives, by matrix shape (A, B),
    the winners the blocked similarity's backward routes by (i1 over v per
    text token, i2 over t per video token); replay_routing: such a dict,
    whose winners a plain backward then routes by instead of its own."""
    from neighborretr_tpu_torch.losses import hubness
    from neighborretr_tpu_torch.models import ctm
    from neighborretr_tpu_torch.ops import similarity_blocked as SB
    real_cluster, real_masks = ctm.cluster_dpc_knn, hubness.neighbor_masks
    feed = iter(replay) if replay is not None else None

    def replayed(real):
        def fn(*args, **kwargs):
            out = next(feed) if feed is not None else None
            if out is None:                 # nothing to replay: decide here
                out = real(*args, **kwargs)
            log.append(out)
            return out
        return fn

    def hook(i1, i2, videos, n_videos):
        key = (i1.shape[0], n_videos)
        if replay_routing is not None:
            r1, r2 = replay_routing[key]
            return r1[:, videos], r2[:, videos]
        if key not in routing:
            routing[key] = tuple(
                torch.empty((x.shape[0], n_videos, x.shape[2]),
                            dtype=torch.uint8, device=x.device)
                for x in (i1, i2))
        routing[key][0][:, videos] = i1
        routing[key][1][:, videos] = i2
        return None

    ctm.cluster_dpc_knn = replayed(real_cluster)
    hubness.neighbor_masks = replayed(real_masks)
    if routing is not None or replay_routing is not None:
        SB.routing_hook = hook
    try:
        yield
    finally:
        ctm.cluster_dpc_knn, hubness.neighbor_masks = real_cluster, real_masks
        SB.routing_hook = None


@contextlib.contextmanager
def plain_attention():
    """Swaps the attention kernel and its backward (K8, K9) for their plain
    versions, and nothing else."""
    from neighborretr_tpu_torch.ops import attention as A
    real = A.frame_attention, A.frame_attention_bwd
    A.frame_attention, A.frame_attention_bwd = (A.attention_plain,
                                                A.attention_bwd_plain)
    try:
        yield
    finally:
        A.frame_attention, A.frame_attention_bwd = real


def phase_train(profile: bool, card: str, attention_impl="auto"):
    """attention_impl "auto": phase 8, the sublayer kernels' route (K1, K3),
    held to a run through the plain versions of everything.  "fused": the
    same run on the attention kernels' route (K8, K9), part of phase 12,
    held to a run with only K8/K9 swapped for their plain version."""
    fused = attention_impl == "fused"
    print(f"== phase {'12b' if fused else '8'}: train run (ViT-B/32 width, "
          f"bf16, batch 128, bank 1920, attention_impl={attention_impl!r})")
    import dataclasses as dc

    from neighborretr_tpu_torch.core.config import Config
    from neighborretr_tpu_torch.data.datasets.synthetic import \
        make_synthetic_batch
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    cfg = Config()      # the reference's MSR-VTT recipe: batch 128, 15 x 128
    cfg = dc.replace(cfg, model=dc.replace(cfg.model,
                                           attention_impl=attention_impl))
    m, B = cfg.model, cfg.train.batch_size
    n_fill, n_steps, t_total = cfg.train.mb_batch, 3, 30
    cap = cfg.train.memory_bank_capacity
    layers = (m.clip.vision_layers + m.clip.transformer_layers
              + m.temporal_layers)
    print(f"  batch {B}, bank {n_fill} x {B} = {cap}, {layers} attention "
          f"sublayers per pass, sim_dtype {m.sim_dtype}, remat {m.remat}")
    model = init_model(m, seed=0, device="cuda")
    start = {k: v.clone() for k, v in model.state_dict().items()}

    t0 = time.perf_counter()
    host = []
    for seed in range(7):       # 4 distinct fill batches, 3 step batches
        b = make_synthetic_batch(m, B, seed=seed)
        b["idx"] = b["idx"] + B * seed
        host.append(TS.to_device(b, "cuda"))
    fill, steps = host[:4], host[4:]
    print(f"  7 synthetic batches made and moved in "
          f"{time.perf_counter() - t0:.2f} s")

    def run(kernels: bool, replay=None, carry=None):
        """Fill and steps from the start weights.  carry: the state another
        run's last step started from (its "before_last"); this run's last
        step is then taken from that state, not from its own."""
        model.load_state_dict(start)
        bank = MB.create(cap, m.max_words, m.max_frames, m.width,
                         device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_fill):
            bank = TS.fill_bank_step(model, bank, fill[i % len(fill)], cfg,
                                     i * B, kernels)
        torch.cuda.synchronize()
        t_fill = time.perf_counter() - t0
        state = TS.create_train_state(model, bank)
        out = dict(metrics=[], ms=[], t_fill=t_fill, decisions=[])
        for i, batch in enumerate(steps):
            if i == n_steps - 1 and carry is None:
                # what the last step starts from: the weights on the card,
                # the moments and the bank on the host
                out["before_last"] = dict(
                    weights={k: v.clone() for k, v
                             in model.state_dict().items()},
                    m={n: t.cpu() for n, t in state.opt.m.items()},
                    v={n: t.cpu() for n, t in state.opt.v.items()},
                    bank=tuple(t.cpu() for t in state.bank))
            elif i == n_steps - 1:
                model.load_state_dict(carry["weights"])
                state = TS.TrainState(
                    model=model, step=state.step,
                    opt=state.opt._replace(
                        m={n: t.cuda() for n, t in carry["m"].items()},
                        v={n: t.cuda() for n, t in carry["v"].items()}),
                    bank=MB.MemoryBank(*(t.cuda() for t in carry["bank"])))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            log = []
            with decisions(log, replay[i] if replay and i < len(replay)
                           else None):
                state, met = TS.train_step(state, batch, cfg, t_total, gen,
                                           kernels)
            torch.cuda.synchronize()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["decisions"].append(log)
            out["metrics"].append({k: v.item() for k, v in met.items()})
            if i == 1:
                out["after_two"] = {k: model.state_dict()[k].clone()
                                    for k in TRAIN_COMPARED}
        out["state"] = state
        out["final"] = {k: model.state_dict()[k].clone()
                        for k in TRAIN_COMPARED + ("clip.visual.conv1.weight",)}
        return out

    # warm-up outside the counted run: cuBLAS/cuDNN handles and heuristics,
    # lazy kernel loading, the allocator's pools at the step's sizes
    warm = TS.create_train_state(model, MB.create(
        cap, m.max_words, m.max_frames, m.width, device="cuda"))
    TS.train_step(warm, steps[0], cfg, t_total,
                  torch.Generator(device="cuda").manual_seed(0))
    del warm
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    k, counts = counted(lambda: run(True))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    fwd, bwd = ("K8", "K9") if fused else ("K1", "K3")
    want = dict.fromkeys(kernel_wrappers(), 0)
    want.update({fwd: (n_fill + n_steps) * layers, bwd: n_steps * layers,
                 "K4": 2 * n_steps, "K5": 2 * n_steps})
    print(f"  launches in the train run: {counts} (expected {want}: per step "
          f"{fwd} = {bwd} = {layers}, K4 = K5 = 2 calls; per fill batch {fwd} "
          f"= {layers})")
    if counts != want:
        raise SystemExit("launch counts do not match the train path")
    for i, met in enumerate(k["metrics"]):
        print(f"  step {i + 1}: " + " ".join(f"{n} {v:.5f}"
                                              for n, v in met.items()))
        if not all(np.isfinite(v) for v in met.values()):
            raise SystemExit(f"non-finite metric at step {i + 1}")
    ms = statistics.median(k["ms"])
    print(f"  bank fill {k['t_fill']:.3f} s for {n_fill} batches; steps "
          f"{' / '.join(f'{t:.1f}' for t in k['ms'])} ms, median {ms:.1f} "
          f"ms/step = {B / ms * 1e3:.2f} pairs/s on {card}; peak device "
          f"memory {peak_gib:.2f} GiB")

    for name in TRAIN_COMPARED:
        if torch.equal(k["after_two"][name], start[name]):
            raise SystemExit(f"{name} did not move in two steps")
    if not torch.equal(k["final"]["clip.visual.conv1.weight"],
                       start["clip.visual.conv1.weight"]):
        raise SystemExit("the frozen patch embedding moved")
    print(f"  {len(TRAIN_COMPARED)} compared parameters moved after step 2; "
          "the frozen conv1 did not")
    bank, last = k["state"].bank, steps[-1]
    # the last batch's features at the weights its step's forward saw,
    # encoded again now that the launch counts have been read
    final = {n: v.clone() for n, v in model.state_dict().items()}
    model.load_state_dict(k["before_last"]["weights"])
    with torch.no_grad():
        fresh = model.get_text_video_feat(
            last["text_ids"], last["text_mask"], last["video"],
            last["video_mask"])
    model.load_state_dict(final)
    del final
    if not torch.equal(bank.ind[:B], last["idx"].to(torch.int32)) or \
            not torch.equal(bank.ind[B:2 * B], steps[-2]["idx"].to(torch.int32)):
        raise SystemExit("the bank's head does not hold the newest batches")
    compare("bank text rows vs the last batch's fresh features",
            bank.feat_t[:B], fresh[0], (1e-6, 0.0))
    compare("bank video rows vs the last batch's fresh features",
            bank.feat_v[:B], fresh[1], (1e-6, 0.0))
    if not torch.equal(bank.mask_t[:B], last["text_mask"].float()):
        raise SystemExit("the bank's masks are not the last batch's")

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as trace:
            TS.train_step(k["state"], steps[0], cfg, t_total,
                          torch.Generator(device="cuda").manual_seed(2))
            torch.cuda.synchronize()
        print("  profile of one train step (device time by kernel):")
        print(trace.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                      max_name_column_width=60))

    if fused:
        # the features of the two runs differ by the kernels' one-ulp flips,
        # as in phase 8's swap of K1/K3 and unlike the trainer's swap of
        # K6/K7 (which see the same features): phase 8's tolerances
        print("  the same fill and steps with only K8/K9 swapped for their "
              "plain version, with the kernel run's cluster ids and "
              "neighbour masks, step 3 from the state its step 3 started "
              "from:")
        with plain_attention():
            p = run(True, k["decisions"], k["before_last"])
    else:
        print("  the same fill and steps through the plain versions on the "
              "card, with the kernel run's cluster ids and neighbour masks, "
              "step 3 from the state its step 3 started from:")
        p = run(False, k["decisions"], k["before_last"])
    failed = []
    for i, (a, b) in enumerate(zip(k["metrics"], p["metrics"])):
        for n in LOSS_TERMS + ("grad_norm",):
            tol = (TRAIN_GRAD_NORM_RTOL[i >= 2] if n == "grad_norm"
                   else TRAIN_LOSS_RTOL)
            rel = abs(a[n] - b[n]) / max(abs(b[n]), 1e-6)
            ok = np.isfinite(b[n]) and rel <= tol
            print(f"  step {i + 1} {n}: kernels {a[n]:.6f} plain {b[n]:.6f} "
                  f"rel {rel:.3g} (tolerance {tol:g}) "
                  f"{'ok' if ok else 'FAILED'}")
            if not ok:
                failed.append(f"step {i + 1} {n}")
    for name in TRAIN_COMPARED:
        dk = (k["final"][name] - start[name]).float()
        dp = (p["final"][name] - start[name]).float()
        rel = ((dk - dp).norm() / dp.norm().clamp_min(1e-30)).item()
        ok = rel <= TRAIN_UPDATE_REL_L2
        print(f"  update of {name}: |Δ| {dp.norm().item():.4g}, kernels vs "
              f"plain rel L2 {rel:.3g} (tolerance {TRAIN_UPDATE_REL_L2:g}) "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(f"update of {name}")
    if failed:
        raise SystemExit("the kernel run disagrees with the plain run: "
                         + ", ".join(failed))
    pms = statistics.median(p["ms"])
    print(f"  plain run: fill {p['t_fill']:.3f} s, median {pms:.1f} ms/step")
    return counts, ms, pms, peak_gib


def _blocked_inputs(g, A, T, B, V, D, exact: bool):
    """Inputs of the blocked similarity with ragged masks and duplicated
    tokens.  exact=False: real-valued features for the wrapper (t_feat,
    v_feat, t_mask, v_mask, tw, vw).  exact=True: prepared inputs (tn, vn,
    tw, vw) whose entries are multiples of 1/64 up to 1/16, so every logit
    (a multiple of 1/4096 below 2, cosine-sized) is exact in fp32 in any
    summation order: the kernel and the plain version then see the same
    maxima and the same (many) ties, and their gradients can be held
    elementwise."""
    dev = "cuda"
    tlen = torch.randint(4, T + 1, (A,), generator=g, device=dev)
    vlen = torch.randint(2, V + 1, (B,), generator=g, device=dev)
    tm = (torch.arange(T, device=dev)[None] < tlen[:, None]).float()
    vm = (torch.arange(V, device=dev)[None] < vlen[:, None]).float()
    tw = torch.softmax(torch.randn(A, T, generator=g, device=dev)
                       .masked_fill(tm == 0, -9e15), -1)
    vw = torch.softmax(torch.randn(B, V, generator=g, device=dev)
                       .masked_fill(vm == 0, -9e15), -1)
    if exact:
        tf = torch.randint(-4, 5, (A, T, D), generator=g, device=dev) / 64.0
        vf = torch.randint(-4, 5, (B, V, D), generator=g, device=dev) / 64.0
    else:
        tf = torch.randn(A, T, D, generator=g, device=dev)
        vf = torch.randn(B, V, D, generator=g, device=dev)
    vf[:, 1] = vf[:, 0]              # ties among live logits over v
    tf[:, 3] = tf[:, 2]              # and over t
    if exact:
        return ((tf * tm[..., None]).contiguous(),
                (vf * vm[..., None]).contiguous(), tw, vw)
    return tf, vf, tm, vm, tw, vw


def check_f64_routed(tag, prep, cot, res):
    """K7 from K6's saved routing, both sides, against the plain routed
    backward fed the routing of float64 logits of the same prepared inputs
    (their first argmax); prints how many of K6's saved indices differ from
    float64's and both feature gradients' relative L2."""
    from neighborretr_tpu_torch.ops import similarity_blocked as SB
    T, V = prep[0].shape[1], prep[1].shape[1]
    _, (m1, i1, m2, i2) = SB.similarity_blocked_routing_plain(
        *(x.double() for x in prep))
    off = (f"{int((res[1][..., :T] != i1).sum())} of {i1.numel()} (i1), "
           f"{int((res[3][..., :V] != i2).sum())} of {i2.numel()} (i2)")
    got = SB.fused_blocked_similarity_bwd(*prep, cot, *res)
    want = SB.similarity_blocked_bwd_routed_plain(
        *prep, cot, m1.float(), i1, m2.float(), i2)
    del m1, i1, m2, i2
    for n, a, b in zip(("dtn", "dvn"), got, want):
        rel = ((a - b).norm() / b.norm()).item()
        ok = bool(torch.isfinite(a).all()) and rel <= K7_F64_REL_L2
        print(f"  K7 {tag} {n} vs the float64-routed plain backward: rel L2 "
              f"{rel:.3g} (tolerance {K7_F64_REL_L2:g}) "
              f"{'ok' if ok else 'FAILED'}; K6's saved indices off "
              f"float64's first argmax: {off}")
        if not ok:
            raise SystemExit(f"K7 {n} disagrees with the float64-routed "
                             "reference")


def phase_k6_k7(g):
    print("== phase 9: K6 interaction_similarity_blocked, K7 its backward vs "
          "their plain versions")
    from neighborretr_tpu_torch.ops import similarity as S
    from neighborretr_tpu_torch.ops import similarity_blocked as SB
    names = ("dtn", "dvn", "dtw", "dvw")
    k6, k7 = {}, {}
    # the long step's two bank calls: text x bank videos differentiates the
    # captions, bank texts x videos the videos
    for A, T, B, V, D in ((128, 64, 1920, 64, 512), (1920, 64, 128, 64, 512)):
        need = "text" if A < B else "video"
        tag = f"A={A} T={T} B={B} V={V} D={D}"
        flops = 2 * A * T * B * V * D

        # through the wrapper, real-valued: forward, and the gradients of a
        # cotangent of the neighbour loss's scale, both feature sides and
        # the train step's one
        args = _blocked_inputs(g, A, T, B, V, D, exact=False)
        cot = torch.randn(A, B, generator=g, device="cuda")

        def grads(kernels, sides):
            leaves = [a.clone().requires_grad_(i in sides)
                      for i, a in enumerate(args)]
            out = SB.fused_interaction_similarity_blocked(*leaves,
                                                          kernels=kernels)
            out.backward(cot)
            return out.detach(), [leaves[i].grad for i in (0, 1, 4, 5)]

        err6 = err7 = 0.0
        for sides in ((0, 1, 4, 5), (0 if need == "text" else 1, 4, 5)):
            got, gk = grads(True, sides)
            torch.cuda.synchronize()
            want, gp = grads(False, sides)
            form = "both sides" if len(sides) == 4 else f"{need} side"
            err6 = max(err6, compare(f"K6 {tag}", got, want, K2_TOL))
            # the weights' gradients depend on the maxima only
            err7 = max(err7, *(compare(
                f"K7 {tag} {n} (real-valued, {form})", a, b, K2_TOL)
                for n, a, b in zip(names[2:], gk[2:], gp[2:])))
            # the features' gradients also on WHICH token attains each max:
            # a runner-up within the two versions' rounding difference
            # (~1e-8) routes otherwise and moves one row by 0.5·g·tw·|Δv|;
            # held as a whole
            for n, a, b in zip(names[:2], gk[:2], gp[:2]):
                if b is None:
                    if a is not None:
                        raise SystemExit(f"K7 {n}: a gradient nobody asked "
                                         "for")
                    continue
                rel = ((a - b).norm() / b.norm()).item()
                ok = bool(torch.isfinite(a).all()) and rel <= K7_REAL_REL_L2
                print(f"  K7 {tag} d{n[1:]} of the features (real-valued, "
                      f"{form}): rel L2 {rel:.3g} (tolerance "
                      f"{K7_REAL_REL_L2:g}) {'ok' if ok else 'FAILED'}")
                if not ok:
                    raise SystemExit(f"K7 {n} disagrees with its plain "
                                     "version")
        # the backward on the kernel forward's own residuals against the
        # plain routed backward on the same ones
        prep = S._prepare(*args, False)
        out, res = SB._blocked_fwd(*prep, save=True)
        e, one = check_routed_bwd(f"K7 {tag}", SB.fused_blocked_similarity_bwd,
                                  SB.similarity_blocked_bwd_routed_plain,
                                  prep, cot, res, need)
        err7 = max(err7, e)
        check_f64_routed(tag, prep, cot, res)

        # exact logits: the saved routing is the plain first argmax, ties
        # included, and all four gradients the plain ones elementwise
        ex = _blocked_inputs(g, A, T, B, V, D, exact=True)
        ex_out, ex_res = SB._blocked_fwd(*ex, save=True)
        torch.cuda.synchronize()
        want_out, want_res = SB.similarity_blocked_routing_plain(*ex)
        err6 = max(err6, compare(f"K6 {tag} (exact logits)", ex_out,
                                 want_out, K2_TOL))
        if not all(torch.equal(a[..., :n], b) for a, b, n in
                   zip(ex_res, want_res, (T, T, V, V))):
            raise SystemExit("K6's saved routing differs from the plain "
                             "first argmax")
        print(f"  K6 {tag}: saved routing equal to the plain first argmax "
              "(exact logits)")
        err7 = max(err7, *(compare(f"K7 {tag} {n} (exact logits)", a, b,
                                   K2_TOL)
                           for n, a, b in zip(
                               names,
                               SB.fused_blocked_similarity_bwd(*ex, cot,
                                                               *ex_res),
                               SB.similarity_blocked_bwd_routed_plain(
                                   *ex, cot, *want_res))))
        del ex, ex_res, want_res

        nograd_ms = time_ms(lambda: SB._blocked_fwd(*prep, save=False), 10)
        ms = time_ms(lambda: SB._blocked_fwd(*prep, save=True), 10)
        plain_ms = time_ms(lambda: SB.similarity_blocked_routing_plain(*prep),
                           3)
        b = sim_bounds(flops, nbytes(*prep, out, *res))
        b_ng = sim_bounds(flops, nbytes(*prep, out))
        print(f"  K6 {tag}: kernel {ms:.4f} ms with the residual stores "
              f"(under autograd), {nograd_ms:.4f} ms without, plain "
              f"{plain_ms:.4f} ms; " + bound_shares(ms, b))
        print(f"  K6 {tag} without the residual stores: "
              + bound_shares(nograd_ms, b_ng))
        k6[(A, B)] = (err6, ms, plain_ms, b[2], b[3], None, b[0])
        k6[(A, B, "no grad")] = (err6, nograd_ms, plain_ms, b_ng[2], b_ng[3],
                                 None, b_ng[0])
        side = dict(need_t=need == "text", need_v=need == "video")
        ms = time_ms(lambda: SB.fused_blocked_similarity_bwd(
            *prep, cot, *res, **side), 10)
        both_ms = time_ms(lambda: SB.fused_blocked_similarity_bwd(
            *prep, cot, *res), 10)
        plain_ms = time_ms(lambda: SB.similarity_blocked_bwd_routed_plain(
            *prep, cot, *res, **side), 2)
        outs = [o for o in one if o is not None]
        b_ms, b_by, live = routed_bound(prep[2], prep[3], D, 1, *prep, cot,
                                        *res, *outs)
        both_b = routed_bound(prep[2], prep[3], D, 2, *prep, cot, *res,
                              *prep)[:2]
        print(f"  K7 {tag} ({need} side, the train step's form): kernel "
              f"{ms:.4f} ms, both sides {both_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; live tokens "
              f"{100 * live:.1f}% of the slots), {100 * b_ms / ms:.1f}% of "
              f"the bound; both sides' bound {both_b[0]:.4f} ms")
        k7[(A, B)] = (err7, ms, plain_ms, b_ms, b_by)
        k7[(A, B, "both sides")] = (err7, both_ms, plain_ms, *both_b)
        del res, out, one

    # the forward at an eval shape: 1,024 captions against 1,024 videos
    n = 1024
    args = _blocked_inputs(g, n, 64, n, 64, 512, exact=False)
    prep = S._prepare(*args, False)
    out = SB._blocked_fwd(*prep, save=False)[0]
    torch.cuda.synchronize()
    rows = slice(0, 128)         # the plain version on the first text block
    err = compare(f"K6 eval shape [{n}, {n}], first 128 rows", out[rows],
                  SB.similarity_blocked_plain(prep[0][rows], prep[1],
                                              prep[2][rows], prep[3]), K2_TOL)
    ms = time_ms(lambda: SB._blocked_fwd(*prep, save=False), 5)
    plain_ms = time_ms(lambda: [SB.similarity_blocked_plain(
        prep[0][s:s + 128], prep[1], prep[2][s:s + 128], prep[3])
        for s in range(0, n, 128)], 2)
    b = sim_bounds(2 * n * 64 * n * 64 * 512, nbytes(*prep, out))
    print(f"  K6 eval A=B={n}: kernel {ms:.4f} ms, plain (8 row blocks) "
          f"{plain_ms:.4f} ms; " + bound_shares(ms, b))
    k6[(n, n)] = (err, ms, plain_ms, b[2], b[3], None, b[0])
    return k6, k7


# K8 returns bf16 like K1: two bf16 rounding steps.  K9's dqkv too, with the
# absolute part against the tensor's largest entry: dK and dV sum L products
# of either sign, so an entry near zero carries the rounding of the large
# terms that cancelled in it.  K8's lse: fp32 sums in another order and the
# hardware's ex2/log
K9_TOL_OF_MAX = 2 ** -7
LSE_TOL = (1e-4, 1e-5)
INDEX_REL_L2 = 3e-2


def _qkv_inputs(g, N, L, H, bias_kind):
    """Packed qkv with unit-variance entries (what the qkv projection of a
    LayerNorm output gives), a cotangent, and the bias."""
    dev, D = "cuda", 64 * H
    qkv = torch.randn(N, L, 3 * D, generator=g, device=dev).bfloat16()
    dout = torch.randn(N, L, D, generator=g, device=dev).bfloat16()
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
    return qkv, dout, bias


def phase_k8_k9(g):
    print("== phase 11: K8 frame_attention, K9 its backward vs their plain "
          "versions")
    import torch.nn.functional as F

    from neighborretr_tpu_torch.ops import attention as A
    # the fused route's shapes: one train step at batch 128 (1536 frames, 128
    # captions and videos), the long recipes' 64 words / 64 frames, then one
    # batch of 16 videos x 12 frames at ViT-B/16 and at ViT-L/14@336px
    shapes = [("vision", 1536, 50, 12, None),
              ("text", 128, 24, 8, "causal"),
              ("temporal", 128, 12, 8, "keypad"),
              ("text long", 128, 64, 8, "causal"),
              ("temporal long", 128, 64, 8, "keypad"),
              ("vision ViT-B/16", 192, 197, 12, None),
              ("vision ViT-L/14@336px", 192, 577, 16, None)]
    k8, k9 = {}, {}
    for name, N, L, H, kind in shapes:
        D = 64 * H
        qkv, dout, bias = _qkv_inputs(g, N, L, H, kind)
        tag = f"{name} N={N} L={L} H={H}"
        got, lse = A.frame_attention(qkv, H, bias, return_lse=True)
        torch.cuda.synchronize()
        want, want_lse = A.attention_plain(qkv, H, bias, return_lse=True)
        err8 = compare(f"K8 {tag}", got, want, K1_TOL)
        compare(f"K8 {tag} lse", lse, want_lse, LSE_TOL)
        # as the autograd node calls it: the forward's out and lse given
        dqkv = A.frame_attention_bwd(qkv, H, dout, bias, out=got, lse=lse)
        torch.cuda.synchronize()
        dwant = A.attention_bwd_plain(qkv, H, dout, bias, out=want,
                                      lse=want_lse)
        err9 = max(compare(f"K9 {tag} {part}", a, b,
                           (K9_TOL_OF_MAX * b.abs().max().item(), 2 ** -6))
                   for part, a, b in zip(("dq", "dk", "dv"),
                                         dqkv.float().split(D, -1),
                                         dwant.float().split(D, -1)))
        if not torch.equal(dqkv, A.frame_attention_bwd(qkv, H, dout, bias,
                                                       out=got, lse=lse)):
            raise SystemExit("K9: two runs differ in their bits")
        print(f"  K9 {tag}: two runs bit-equal in all of dqkv")
        del want, dwant, want_lse

        # the library's call for the same function, as a yardstick only:
        # strided [N, H, L, 64] views of the packed buffer, the bias in the
        # operands' type; its backward from its own saved statistics
        q, k, v = (t.view(N, L, H, 64).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        mask = None if bias is None else bias.bfloat16()[:, None]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).reshape(N, L, D).float()
                   - got.float()).abs().max().item()
        lib_g = dout.view(N, L, H, 64).transpose(1, 2)

        def line(kern, ms, plain_ms, lib_name, lib_ms, flops, b_ms, b_by):
            print(f"  {kern} {name}: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the "
                  f"bound {b_ms:.4f} ms by {b_by}), plain {plain_ms:.4f} ms, "
                  f"{lib_name} {lib_ms:.4f} ms (kernel / library "
                  f"{ms / lib_ms:.2f}x)")

        reps = 5 if L > 64 else 20
        ms = time_ms(lambda: A.frame_attention(qkv, H, bias,
                                               return_lse=True), reps)
        plain_ms = time_ms(lambda: A.attention_plain(qkv, H, bias,
                                                     return_lse=True), 3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), reps)
        flops = 4 * N * L * L * D
        b_ms, b_by = bound(flops, PEAK_BF16, nbytes(qkv, bias, got, lse))
        print(f"  K8 {name}: max |Δ| of scaled_dot_product_attention to the "
              f"kernel {lib_err:.3g}")
        line("K8", ms, plain_ms, "scaled_dot_product_attention", lib_ms,
             flops, b_ms, b_by)
        k8[name] = (err8, ms, plain_ms, b_ms, b_by, lib_ms)
        ms = time_ms(lambda: A.frame_attention_bwd(qkv, H, dout, bias,
                                                   out=got, lse=lse), reps)
        plain_ms = time_ms(lambda: A.attention_bwd_plain(
            qkv, H, dout, bias, out=got, lse=lse), 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            lib, leaves, lib_g, retain_graph=True), reps)
        # the gradient needs 10·N·L²·D with S recomputed once; the kernels
        # do 14 (S and dP in both the dQ and the dK/dV kernel)
        flops = 10 * N * L * L * D
        b_ms, b_by = bound(flops, PEAK_BF16,
                           nbytes(qkv, bias, dout, got, lse, dqkv))
        line("K9", ms, plain_ms, "scaled_dot_product_attention's backward",
             lib_ms, flops, b_ms, b_by)
        k9[name] = (err9, ms, plain_ms, b_ms, b_by, lib_ms)
        del lib, leaves, dqkv, got, lse
    return k8, k9


def phase_backbone(name: str, settings, card: str, profile: bool = False):
    """The index and search CLIs on 16 synthetic videos, then train steps at
    batch 16 x 12 frames x 24 words against a bank of 15 x 16 = 240, with a
    larger backbone at full depth (seeded random weights, bf16,
    attention_impl="auto": the vision tower's sequences are longer than the
    sublayer kernel takes and go to K8/K9, text and temporal stay on K1/K3).
    settings: (label, ModelConfig changes, steps) — every setting starts
    from the same weights, bank, batches and noise, so their first steps
    compute the same function.  profile: one more step under the first
    setting, profiled.  → (counts of the CLIs, counts per setting)."""
    import dataclasses as dc
    import tempfile

    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.cli import index as cli_index
    from neighborretr_tpu_torch.cli import search as cli_search
    from neighborretr_tpu_torch.cli.common import RANDOM_WEIGHTS_SEED
    from neighborretr_tpu_torch.core.config import (ClipConfig, Config,
                                                    ModelConfig, TrainConfig)
    from neighborretr_tpu_torch.data.datasets.synthetic import (
        SyntheticDataset, make_synthetic_batch)
    from neighborretr_tpu_torch.eval import encode_video_batch
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    clip = ClipConfig.from_name(name)
    m = ModelConfig(clip=clip)
    L = clip.grid_size ** 2 + 1
    layers = clip.vision_layers + clip.transformer_layers + m.temporal_layers
    small = clip.transformer_layers + m.temporal_layers   # on K1/K3
    print(f"  {name}: {clip.vision_layers}x{clip.vision_width} vision at "
          f"{L} tokens ({clip.vision_heads} heads, {clip.image_resolution}px),"
          f" {clip.transformer_layers}x{clip.transformer_width} text, "
          f"{m.temporal_layers} temporal, embed {clip.embed_dim}")
    n_videos, B = 16, 16
    queries = ["a man is cooking pasta in a kitchen",
               "dog catching a frisbee on the beach"]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_index_") as tmp:
        path = os.path.join(tmp, "index.npz")
        common = ["--base_encoder", name, "--device", "cuda"]

        def clis():
            t0 = time.perf_counter()
            cli_index.main(["--datatype", "synthetic", "--synthetic_size",
                            str(n_videos), "--batch_size", str(n_videos),
                            "--out", path, "--workers", "4"] + common)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            argv = ["--index", path] + common
            for q in queries:
                argv += ["--query", q]
            cli_search.main(argv)
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1

        (t_index, t_search), cli_counts = counted(clis)
        index = serving.load_index(path)
    want = dict.fromkeys(kernel_wrappers(), 0)
    want.update({"K8": clip.vision_layers, "K1": small, "K2": 1})
    print(f"  launches in cli.index + cli.search: {cli_counts} (expected "
          f"{want}: the vision tower's {clip.vision_layers} sublayers at L = "
          f"{L} on K8, temporal and text on K1)")
    if cli_counts != want:
        raise SystemExit(f"launch counts do not match the {name} CLIs")
    feats = torch.as_tensor(index["v_feat"].astype(np.float32))
    if feats.shape != (n_videos, m.max_frames, clip.embed_dim) or \
            not torch.isfinite(feats).all():
        raise SystemExit(f"index features {tuple(feats.shape)} not finite")
    print(f"  index of {n_videos} videos in {t_index:.2f} s (model built, "
          f"{n_videos / t_index:.2f} videos/s), search of {len(queries)} "
          f"queries in {t_search:.2f} s (model built)")

    # the first videos again through the plain versions, same seeded weights
    model = init_model(m, RANDOM_WEIGHTS_SEED, "cuda")
    ds = SyntheticDataset(n=n_videos, seed=2, max_words=m.max_words,
                          max_frames=m.max_frames,
                          resolution=clip.image_resolution,
                          vocab_size=clip.vocab_size)
    rows = [ds.item(i) for i in range(2)]
    plain = encode_video_batch(model, np.stack([r["video"] for r in rows]),
                               np.stack([r["video_mask"] for r in rows]),
                               kernels=False).cpu()
    # unnormalised fp16 features behind bf16 towers of up to 24 + 4 layers,
    # where a one-ulp flip (2^-8) in one layer carries into the next: held
    # as a whole
    rel = ((feats[:2] - plain).norm() / plain.norm()).item()
    ok = rel <= INDEX_REL_L2
    print(f"  {name} index rows of 2 videos vs the plain versions: rel L2 "
          f"{rel:.3g} (tolerance {INDEX_REL_L2:g}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{name}: the index disagrees with the plain "
                         "versions")
    del plain

    # ---- train steps
    base = Config(model=m, train=TrainConfig(batch_size=B, mb_batch=15))
    cap, n_fill, t_total = base.train.memory_bank_capacity, 15, 30
    start = {k: v.clone() for k, v in model.state_dict().items()}
    host = []
    for seed in range(6):          # 4 distinct fill batches, 2 step batches
        b = make_synthetic_batch(m, B, seed=seed)
        b["idx"] = b["idx"] + B * seed
        host.append(TS.to_device(b, "cuda"))
    fill, steps = host[:4], host[4:]
    bank0 = MB.create(cap, m.max_words, m.max_frames, m.width, device="cuda")
    t0 = time.perf_counter()
    for i in range(n_fill):
        bank0 = TS.fill_bank_step(model, bank0, fill[i % len(fill)], base,
                                  i * B)
    torch.cuda.synchronize()
    print(f"  bank of {cap} filled in {time.perf_counter() - t0:.2f} s")

    # warm-up outside the counted runs: cuBLAS heuristics and the allocator's
    # pools at this backbone's sizes, under the first setting
    model.cfg = dc.replace(m, **settings[0][1])
    TS.train_step(TS.create_train_state(
        model, MB.MemoryBank(*(t.clone() for t in bank0))), steps[0],
        dc.replace(base, model=model.cfg), t_total,
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()

    results = {}
    for label, changes, n_steps in settings:
        cfg = dc.replace(base, model=dc.replace(m, **changes))
        model.cfg = cfg.model        # what the towers read
        model.load_state_dict(start)
        state = TS.create_train_state(
            model, MB.MemoryBank(*(t.clone() for t in bank0)))
        gen = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run():
            st, mets, ms = state, [], []
            for batch in steps[:n_steps]:
                t0 = time.perf_counter()
                st, met = TS.train_step(st, batch, cfg, t_total, gen)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                mets.append({k: v.item() for k, v in met.items()})
            return mets, ms

        (mets, ms), counts = counted(run)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, met in enumerate(mets):
            print(f"  {label} step {i + 1}: " + " ".join(
                f"{n} {v:.5f}" for n, v in met.items()))
            if not all(np.isfinite(v) for v in met.values()):
                raise SystemExit(f"{name} {label}: non-finite metric")
        # per step: every sublayer once forward and once backward, and once
        # more forward where its block (or its chunk) is rematerialised as a
        # whole; the temporal tower never is
        mc = cfg.model
        chunks = (-(-B * m.max_frames // mc.video_chunk_frames)
                  if mc.video_chunk_frames else 0)
        again = bool(chunks) or (mc.remat and mc.remat_policy != "attn")
        text_again = mc.remat and mc.remat_policy != "attn"
        per = max(chunks, 1)
        want = dict.fromkeys(kernel_wrappers(), 0)
        want.update({
            "K8": n_steps * per * clip.vision_layers * (2 if again else 1),
            "K9": n_steps * per * clip.vision_layers,
            "K1": n_steps * (small + (clip.transformer_layers if text_again
                                      else 0)),
            "K3": n_steps * small, "K4": 2 * n_steps, "K5": 2 * n_steps})
        print(f"  {label}: launches {counts} (expected {want}), steps "
              f"{' / '.join(f'{t:.0f}' for t in ms)} ms = "
              f"{B / min(ms) * 1e3:.2f} pairs/s on {card}, peak device "
              f"memory {peak:.2f} GiB")
        if counts != want:
            raise SystemExit(f"launch counts do not match {name} {label}")
        sd = model.state_dict()
        if not torch.equal(sd["clip.visual.conv1.weight"],
                           start["clip.visual.conv1.weight"]):
            raise SystemExit("the frozen patch embedding moved")
        if n_steps >= 2 and torch.equal(sd["clip.text_projection"],
                                        start["clip.text_projection"]):
            raise SystemExit("clip.text_projection did not move in two steps")
        results[label] = dict(counts=counts, metrics=mets, ms=ms, peak=peak)
        del state

    # every setting's first step is the same function of the same inputs:
    # rematerialisation and chunking change what is kept, not what is
    # computed.  Held to what one step differs from its own repeat by
    # (torch's float-atomic scatter-adds; chunks also give the products
    # other shapes): the loss to 1e-4, the gradient norm to 1e-2
    first = next(iter(results))
    for label, r in list(results.items())[1:]:
        for key, tol in (("loss", 1e-4), ("grad_norm", 1e-2)):
            a, b = r["metrics"][0][key], results[first]["metrics"][0][key]
            rel = abs(a - b) / abs(b)
            same = "bit-equal" if a == b else f"rel {rel:.3g}"
            print(f"  step 1 {key}: {label} {a:.7f} vs {first} {b:.7f} "
                  f"({same}, tolerance {tol:g}) "
                  f"{'ok' if rel <= tol else 'FAILED'}")
            if rel > tol:
                raise SystemExit(f"{name}: step 1 {key} differs between "
                                 f"{label} and {first}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        label, changes, _ = settings[0]
        model.cfg = dc.replace(m, **changes)
        model.load_state_dict(start)
        state = TS.create_train_state(
            model, MB.MemoryBank(*(t.clone() for t in bank0)))
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as trace:
            TS.train_step(state, steps[0], dc.replace(base, model=model.cfg),
                          t_total,
                          torch.Generator(device="cuda").manual_seed(2))
            torch.cuda.synchronize()
        print(f"  profile of one {name} train step under {label} (device "
              "time by kernel):")
        print(trace.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=25,
                                         max_name_column_width=60))
        del state
    del model, start
    torch.cuda.empty_cache()
    return cli_counts, results


def phase_vit_l(card: str, profile: bool = False):
    print("== phase 13: ViT-L/14@336px (depth not cut) and ViT-B/16: index and "
          "search CLIs, rematerialised train steps")
    _, b16 = phase_backbone("ViT-B/16", [("no remat", {}, 1)], card)
    cli_counts, res = phase_backbone("ViT-L/14@336px", [
        ("remat full", dict(remat=True, remat_policy="full"), 2),
        ("remat attn", dict(remat=True, remat_policy="attn"), 1),
        ("video_chunk_frames=48", dict(remat=True, video_chunk_frames=48), 1),
    ], card, profile)
    counts = dict(cli_counts)
    for r in list(res.values()) + list(b16.values()):
        for k, v in r["counts"].items():
            counts[k] += v
    return counts, res


# the kernel check's own bound (scripts/pallas_tpu_check.py's block check):
# each weight gradient of the bf16 kernels within 5% of the fp32 plain
# composition, relative to the tensor's largest entry
K10_CHECK_REL = 0.05


def phase_k10_k11(g):
    print("== phase 14: K10 attention_sublayer, K11 its backward: the kernel "
          "check, then against their plain versions (whole heads, then a "
          "tensor-parallel rank's half)")
    import torch.nn as nn

    from neighborretr_tpu_torch.ops import block_attention as BA
    dev = "cuda"

    # the kernel check (N=768, L=50, H=12: ViT-B/32's vision tower at index
    # batch 64): weights N(0, 0.02), zero biases, h N(0, 1), loss sum(y),
    # through the public function as a user calls it
    N, L, D, H = 768, 50, 768, 12
    h = torch.randn(N, L, D, generator=g, device=dev)
    w = [torch.randn(3 * D, D, generator=g, device=dev) * 0.02,
         torch.zeros(3 * D, device=dev),
         torch.randn(D, D, generator=g, device=dev) * 0.02,
         torch.zeros(D, device=dev)]

    def check():
        leaves = [t.clone().requires_grad_(True) for t in [h] + w]
        BA.fused_attention_sublayer(*leaves, H).float().sum().backward()
        torch.cuda.synchronize()
        return [t.grad for t in leaves]

    grads, check_counts = counted(check)
    want = dict.fromkeys(kernel_wrappers(), 0)
    want.update({"K10": 1, "K11": 1})
    print(f"  launches in the kernel check: {check_counts} (expected {want})")
    if check_counts != want:
        raise SystemExit("launch counts do not match the kernel check")
    ref = BA.attention_sublayer_bwd_plain(h, *w, H, torch.ones_like(h))
    for name, a, b in zip(("dh", "dw_qkv", "db_qkv", "dw_out", "db_out"),
                          grads, ref):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        ok = bool(torch.isfinite(a).all()) and rel < K10_CHECK_REL
        print(f"  kernel check {name}: max |kernel - fp32 plain| / max |fp32 "
              f"plain| = {rel:.4g} (bound {K10_CHECK_REL:g}) "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit(f"K10/K11 kernel check: {name} off by {rel:.4g}")
    del grads, ref

    # then the shapes of phase 19's tensor-parallel path (a): a rank's half
    # of the heads (H/2, E = D/2: its rows of q, k and v of W_qkv, its
    # columns of W_o) at global batch 32 x 12 frames
    shapes = [("vision check", 768, 50, 768, 12, None, 1),
              ("vision train", 1536, 50, 768, 12, None, 1),
              ("text", 128, 24, 512, 8, "causal", 1),
              ("temporal", 128, 12, 512, 8, "keypad", 1),
              ("vision tp/2", 384, 50, 768, 12, None, 2),
              ("text tp/2", 32, 24, 512, 8, "causal", 2),
              ("temporal tp/2", 32, 12, 512, 8, "keypad", 2)]
    names = ("dw_qkv", "db_qkv", "dw_out", "db_out")
    k10, k11 = {}, {}
    for name, N, L, D, H, kind, tp in shapes:
        (h, _, _, *w), bias = _attn_inputs(g, N, L, D, kind)
        H, E = H // tp, D // tp
        if tp > 1:                 # rank 0's part of the split sublayer
            w = [w[0].view(3, D, D)[:, :E].reshape(3 * E, D).contiguous(),
                 w[1].view(3, D)[:, :E].reshape(3 * E).contiguous(),
                 w[2][:, :E].contiguous(), w[3]]
        dy = torch.randn(N, L, D, generator=g, device=dev).bfloat16()
        tag = f"{name} N={N} L={L} D={D} H={H}"
        y = BA.attention_sublayer(h, *w, H, bias)
        torch.cuda.synchronize()
        err10 = compare(f"K10 {tag}", y,
                        BA.attention_sublayer_plain(h, *w, H, bias), K1_TOL)
        got = BA.attention_sublayer_bwd(h, *w, H, dy, bias)
        torch.cuda.synchronize()
        plain = BA.attention_sublayer_bwd_plain(h, *w, H, dy, bias)
        err11 = compare(f"K11 {tag} dh", got[0], plain[0], K1_TOL)
        for out_name, a, b in zip(names, got[1:], plain[1:]):
            scale = b.abs().max().item()
            e = (a - b).abs().max().item()
            ok = bool(torch.isfinite(a).all()) and e <= K3_SUM_TOL * scale
            print(f"  K11 {tag} {out_name}: max_abs_err {e:.6g} against max "
                  f"|plain| {scale:.6g} (tolerance {K3_SUM_TOL:g}·max|plain|)"
                  f" {'ok' if ok else 'FAILED'}")
            if not ok:
                raise SystemExit(f"K11 {out_name} disagrees with its plain "
                                 "version")
            err11 = max(err11, e)
        again = BA.attention_sublayer_bwd(h, *w, H, dy, bias)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit("K11: two runs differ in their bits")
        print(f"  K11 {tag}: two runs bit-equal in all 5 outputs")
        del plain, again

        M = N * L
        if tp > 1:      # no PyTorch call computes a part of the heads
            ms = time_ms(lambda: BA.attention_sublayer(h, *w, H, bias), 20)
            plain_ms = time_ms(
                lambda: BA.attention_sublayer_plain(h, *w, H, bias), 10)
            b_ms, b_by = bound(8 * M * D * E + 4 * N * L * L * E, PEAK_BF16,
                               nbytes(h, *w, bias, y))
            print(f"  K10 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{100 * b_ms / ms:.1f}% of the bound")
            k10[name] = (err10, ms, plain_ms, b_ms, b_by, None)
            ms = time_ms(lambda: BA.attention_sublayer_bwd(h, *w, H, dy,
                                                           bias), 10)
            plain_ms = time_ms(lambda: BA.attention_sublayer_bwd_plain(
                h, *w, H, dy, bias), 3)
            b_ms, b_by = bound(22 * M * D * E + 12 * N * L * L * E,
                               PEAK_BF16, nbytes(h, *w, bias, dy, *got))
            print(f"  K11 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{100 * b_ms / ms:.1f}% of the bound")
            k11[name] = (err11, ms, plain_ms, b_ms, b_by, None)
            del got, y
            continue

        # the library's call for the same function, as a yardstick only:
        # nn.MultiheadAttention with the same bf16 weights, the bias as a
        # float mask per (sequence, head)
        lib = nn.MultiheadAttention(D, H, batch_first=True, device=dev,
                                    dtype=torch.bfloat16)
        with torch.no_grad():
            lib.in_proj_weight.copy_(w[0])
            lib.in_proj_bias.copy_(w[1])
            lib.out_proj.weight.copy_(w[2])
            lib.out_proj.bias.copy_(w[3])
        mask = (None if bias is None else bias.bfloat16().repeat_interleave(
            H, dim=0))
        with torch.no_grad():
            lib_y = lib(h, h, h, need_weights=False, attn_mask=mask)[0]
        lib_err = (lib_y.float() - y.float()).abs().max().item()
        hl = h.detach().requires_grad_(True)
        lib_out = lib(hl, hl, hl, need_weights=False, attn_mask=mask)[0]
        lib_leaves = [hl] + list(lib.parameters())

        ms = time_ms(lambda: BA.attention_sublayer(h, *w, H, bias), 20)
        plain_ms = time_ms(lambda: BA.attention_sublayer_plain(h, *w, H, bias),
                           10)
        with torch.no_grad():
            lib_ms = time_ms(lambda: lib(h, h, h, need_weights=False,
                                         attn_mask=mask), 20)
        b_ms, b_by = bound(8 * M * D * D + 4 * N * L * L * D, PEAK_BF16,
                           nbytes(h, *w, bias, y))
        print(f"  K10 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"nn.MultiheadAttention {lib_ms:.4f} ms (max |Δ| to the kernel "
              f"{lib_err:.3g}), bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / ms:.1f}% of the bound, kernel / library "
              f"{ms / lib_ms:.3f}")
        k10[name] = (err10, ms, plain_ms, b_ms, b_by, lib_ms)
        ms = time_ms(lambda: BA.attention_sublayer_bwd(h, *w, H, dy, bias), 10)
        plain_ms = time_ms(
            lambda: BA.attention_sublayer_bwd_plain(h, *w, H, dy, bias), 3)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, dy, retain_graph=True), 10)
        # with the recompute of qkv and the probabilities
        b_ms, b_by = bound(22 * M * D * D + 12 * N * L * L * D, PEAK_BF16,
                           nbytes(h, *w, bias, dy, *got))
        print(f"  K11 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"nn.MultiheadAttention's backward {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of the bound, "
              f"kernel / library {ms / lib_ms:.3f}")
        k11[name] = (err11, ms, plain_ms, b_ms, b_by, lib_ms)
        del lib, lib_out, lib_leaves, hl, got, y
    return check_counts, k10, k11


# the device augment on the card against the CPU, given the same draws:
# the same fp32 arithmetic in the same order, but cos/sin (rotations) may
# differ in their last bit between the two libraries, and a tap position an
# ulp across a pixel boundary moves the bilinear blend by one level
AUGMENT_SHARE = 0.005


def _structured_video(g, B, F, H, W):
    """uint8 [B, F, H, W, 3] on g's device: per clip a colour ramp in
    [lo, hi] at a random angle, a flat patch, a band of stripes (sharp
    edges), noise in the left quarter, each frame shifted by one column.
    Random noise would leave AutoContrast and Equalize inert."""
    dev = g.device

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    yy = torch.arange(H, device=dev).float().view(1, H, 1, 1)
    xx = torch.arange(W, device=dev).float().view(1, 1, W, 1)
    ang = rand(B, 1, 1, 1) * 2 * np.pi
    t = torch.cos(ang) * xx / W + torch.sin(ang) * yy / H
    t = (t - t.amin((1, 2), keepdim=True)) / (
        t.amax((1, 2), keepdim=True) - t.amin((1, 2), keepdim=True))
    lo, hi = 20 + 60 * rand(B, 1, 1, 1), 160 + 75 * rand(B, 1, 1, 1)
    img = lo + (hi - lo) * torch.cat([t, t.flip(1), 1 - t], dim=-1)
    img[:, H // 4:H // 2, W // 4:W // 2] = lo + (hi - lo) * rand(B, 1, 1, 3)
    img[:, :, 2 * W // 3:] = torch.where((yy % 8) < 4, hi, lo)
    frames = []
    for f in range(F):
        fr = torch.roll(img, f, dims=2)
        fr[:, :, :W // 4] += 12 * torch.randn(B, H, W // 4, 3, generator=g,
                                               device=dev)
        frames.append(fr)
    return torch.stack(frames, 1).round().clamp(0, 255).to(torch.uint8)


AUGMENT_ARGV = [
    "--datatype", "synthetic", "--clip_checkpoint", "random",
    "--max_words", "24", "--max_frames", "12", "--batch_size", "128",
    "--mb_batch", "15", "--epochs", "1", "--synthetic_size", "384",
    "--batch_size_val", "128", "--n_display", "1", "--mid_epoch_eval", "0",
    "--workers", "8", "--seed", "42", "--augment_backend", "device"]


def phase_augment(card: str, block_ms: float):
    print("== phase 15: device RandAugment (--augment_backend device)")
    import shutil
    import tempfile

    from neighborretr_tpu_torch.cli import train as cli
    from neighborretr_tpu_torch.ops import device_augment as DA
    from neighborretr_tpu_torch.train import loop as LOOP
    from neighborretr_tpu_torch.train import step as TS

    # (a) the card against the CPU: 8 clips x 12 frames x 224², each of the
    # 16 ops fired twice over 4 layers, levels and signs drawn
    B, F, R, n = 8, 12, 224, 4
    g = torch.Generator(device="cuda").manual_seed(15)
    video = _structured_video(g, B, F, R, R)
    slot = torch.arange(B * n, device="cuda").view(B, n)
    op = slot % len(DA.OP_NAMES)
    fire = torch.ones(B, n, dtype=torch.bool, device="cuda")
    level = torch.rand(B, n, generator=g, device="cuda") * 10
    neg = (slot // len(DA.OP_NAMES)) % 2 == 1
    pol = DA.DeviceAugmentPolicy()
    t0 = time.perf_counter()
    got = DA.apply_randaugment_draws(video, op, fire, level, neg, pol)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = DA.apply_randaugment_draws(
        video.cpu(), op.cpu(), fire.cpu(), level.cpu(), neg.cpu(), pol)
    t_cpu = time.perf_counter() - t0
    d = (got.cpu().int() - want.int()).abs()
    share = (d > 0).float().mean().item()
    moved = (want != video.cpu()).float().mean().item()
    ok = d.max().item() <= 1 and share <= AUGMENT_SHARE and moved > 0.1
    print(f"  (a) [{B}, {F}, {R}, {R}, 3], all 16 ops: card vs CPU max |Δ| "
          f"{d.max().item()}, pixels differing {share:.3g} (bound |Δ| <= 1 "
          f"on at most {AUGMENT_SHARE:g}); {moved:.3g} of the pixels moved by "
          f"the policy; card {t_card:.3f} s (first call), CPU {t_cpu:.3f} s "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("device augment: the card disagrees with the CPU")
    del video, got, want, d

    # (b) one flagship batch: 128 x 12 x 224² x 3 uint8, the recipe's policy
    B = 128
    video = _structured_video(g, B, F, R, R)
    mask = torch.ones(B, F, device="cuda")
    policy = "rand-m7-n4-mstd0.5-inc1"
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    aug_ms = time_ms(lambda: DA.augment_batch(video, mask, g, policy), 10)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"  (b) augment_batch at [{B}, {F}, {R}, {R}, 3] uint8 "
          f"({nbytes(video) / 1e6:.0f} MB), {policy}: {aug_ms:.3f} ms per "
          f"batch (median of 10, fresh draws each) on {card}; peak device "
          f"memory above the batch {peak:.3f} GiB")
    del video, mask

    # (c) the train CLI under --augment_backend device
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_augment_")
    argv = AUGMENT_ARGV + ["--output_dir", out_dir]
    args = cli.parse_args(argv)
    cfg = cli.build_config(args)
    m = cfg.model
    layers = (m.clip.vision_layers + m.clip.transformer_layers
              + m.temporal_layers)
    n_steps = args.synthetic_size // args.batch_size
    print(f"  (c) {' '.join(argv[:-2])}")
    real_step, real_aug = LOOP.train_step, TS._maybe_device_augment
    record = {"ms": [], "metrics": [], "changed": []}

    def augment(cfg, batch, generator, *mesh):
        out = real_aug(cfg, batch, generator, *mesh)
        record["changed"].append(
            (out["video"] != batch["video"]).float().mean().item())
        return out

    def step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = real_step(*a, **kw)
        torch.cuda.synchronize()
        record["ms"].append(1e3 * (time.perf_counter() - t0))
        record["metrics"].append({k: v.item() for k, v in met.items()})
        return state, met

    def run():
        LOOP.train_step, TS._maybe_device_augment = step, augment
        try:
            return cli.main(argv)
        finally:
            LOOP.train_step, TS._maybe_device_augment = real_step, real_aug

    try:
        (state, tracker), counts = counted(run)
        log = open(os.path.join(out_dir, "log.txt")).read()
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            ev = [r for r in map(json.loads, f) if r["kind"] == "eval"]
        has_best = os.path.exists(os.path.join(out_dir, "best.npz"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if len(ev) != 1 or not 0 <= ev[0]["t2v"]["R1"] <= 100:
        raise SystemExit("no evaluation row in metrics.jsonl")
    # the epoch's eval, and the final test on the best weights, which exist
    # only where that eval found a hit (mean R@1 > 0; at random weights
    # about six runs in seven)
    if has_best != (ev[0]["t2v"]["R1"] + ev[0]["v2t"]["R1"] > 0):
        raise SystemExit("best.npz and the eval's R@1 disagree")
    n_evals, eval_batches = 1 + has_best, 1
    want = dict.fromkeys(kernel_wrappers(), 0)
    want.update({"K1": (2 * n_steps + n_evals * eval_batches) * layers,
                 "K3": n_steps * layers, "K4": 2 * n_steps,
                 "K5": 2 * n_steps, "K2": n_evals})
    print(f"  launches in the run: {counts} (expected {want}: per step K1 = "
          f"K3 = {layers}, K4 = K5 = 2, as in phase 8; per fill or eval "
          f"batch K1 = {layers}; per evaluation K2 = 1)")
    if counts != want:
        raise SystemExit("launch counts do not match the augment train path")
    if state.step != n_steps or len(record["metrics"]) != n_steps:
        raise SystemExit(f"the run took {state.step} steps")
    for i, met in enumerate(record["metrics"]):
        print(f"  step {i + 1}: " + " ".join(f"{k} {v:.5f}"
                                              for k, v in met.items()))
        if not all(np.isfinite(v) for v in met.values()):
            raise SystemExit(f"non-finite metric at step {i + 1}")
    # the fill's batches, then the steps'
    changed = record["changed"]
    print(f"  augmented batches: {len(changed)} (fill {n_steps}, steps "
          f"{n_steps}); share of pixels changed per batch "
          f"{' / '.join(f'{c:.3g}' for c in changed)}")
    if len(changed) != 2 * n_steps or min(changed) <= 0:
        raise SystemExit("a batch went through unaugmented")
    if "memory bank filled" not in log:
        raise SystemExit("log.txt lacks 'memory bank filled'")
    if ("Final test on best" in log) != has_best:
        raise SystemExit("log.txt and best.npz disagree on the final test")
    ms = statistics.median(record["ms"])
    print(f"  eval: t2v R@1 {ev[0]['t2v']['R1']:.2f} R@5 "
          f"{ev[0]['t2v']['R5']:.2f} v2t R@1 {ev[0]['v2t']['R1']:.2f} (random "
          f"weights); steps {' / '.join(f'{t:.1f}' for t in record['ms'])} "
          f"ms, median {ms:.1f} ms/step with the device augment against "
          f"{block_ms:.1f} ms/step without it (phase 8) on {card}")
    return counts, aug_ms, ms


TRAINER_ARGV = [
    "--datatype", "synthetic", "--clip_checkpoint", "random",
    "--max_words", "64", "--max_frames", "64", "--batch_size", "128",
    "--mb_batch", "15", "--micro_batches", "8", "--epochs", "1",
    "--synthetic_size", "384", "--batch_size_val", "256", "--n_display", "1",
    "--mid_epoch_eval", "0", "--workers", "8", "--seed", "42"]


def phase_trainer(profile: bool, card: str):
    print("== phase 10: long-token trainer (cli/train.py, ViT-B/32 width, "
          "bf16, 64 words x 64 frames, batch 128, bank 1920, 8 micro-batches)")
    import shutil
    import signal
    import tempfile

    from neighborretr_tpu_torch.cli import train as cli
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    from neighborretr_tpu_torch.models import weights_io
    from neighborretr_tpu_torch.train import loop as LOOP

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    carried = out_dir + "_state_preempt.npz"   # outlives the reference runs
    argv = TRAINER_ARGV + ["--output_dir", out_dir]
    args = cli.parse_args(argv)
    cfg = cli.build_config(args)
    m, B = cfg.model, cfg.train.batch_size
    layers = (m.clip.vision_layers + m.clip.transformer_layers
              + m.temporal_layers)
    n_micro, n_steps = cfg.train.micro_batches, args.synthetic_size // B
    n_test = max(32, args.batch_size_val)
    print(f"  {' '.join(argv[:-2])}")
    print(f"  {n_steps} steps per epoch, fill of {n_steps} batches into a "
          f"bank of {cfg.train.memory_bank_capacity}, test set of {n_test} "
          f"pairs, "
          f"{layers} attention sublayers per pass, sim_dtype {m.sim_dtype}")
    start = {k: v.clone() for k, v in weights_io.init_model(
        m, cfg.train.seed, "cuda").state_dict().items()
        if k in TRAIN_COMPARED}

    real_step = LOOP.train_step

    def instrumented(record, stop_after=None, replay=None, carry=None):
        """train/loop.py's train_step, timed, its metrics and discrete
        decisions recorded per global step; SIGTERM after `stop_after`.
        carry: a train-state file that holds the state before the last step;
        the last step is then taken from that state, not the run's own."""
        def step(state, batch, *a, **kw):
            i = state.step
            if carry is not None and i == n_steps - 1:
                state = ckpt.load_train_state(carry, state)
                if state.step != i:
                    raise SystemExit(f"{carry} holds step {state.step}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            log = []
            with decisions(log, replay[i] if replay and i < len(replay)
                           else None):
                state, met = real_step(state, batch, *a, **kw)
            torch.cuda.synchronize()
            record[i] = dict(ms=1e3 * (time.perf_counter() - t0),
                             decisions=log,
                             metrics={k: v.item() for k, v in met.items()})
            if stop_after is not None and state.step == stop_after:
                signal.raise_signal(signal.SIGTERM)
            return state, met
        return step

    def rows(kind):
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            return [r for r in map(json.loads, f) if r["kind"] == kind]

    try:
        k = {}
        torch.cuda.reset_peak_memory_stats()

        def interrupted_then_resumed():
            LOOP.train_step = instrumented(k, stop_after=n_steps - 1)
            t0 = time.perf_counter()
            cut, _ = cli.main(argv)
            t_cut = time.perf_counter() - t0
            if cut.step != n_steps - 1:
                raise SystemExit(f"the interrupted run stopped at step "
                                 f"{cut.step}, not {n_steps - 1}")
            ppath = os.path.join(out_dir, "state_preempt.npz")
            with np.load(ppath) as f:
                saved = int(f["step"])
                keys = len(f.files)
            print(f"  SIGTERM after step {cut.step}: {ppath} holds step "
                  f"{saved} in {keys} arrays, "
                  f"{os.path.getsize(ppath) / 2 ** 30:.2f} GiB; run took "
                  f"{t_cut:.1f} s")
            if saved != n_steps - 1:
                raise SystemExit("state_preempt.npz holds the wrong step")
            del cut
            LOOP.train_step = instrumented(k)
            t0 = time.perf_counter()
            state, tracker = cli.main(argv + ["--resume", "auto"])
            return state, tracker, t_cut, time.perf_counter() - t0

        try:
            (state, tracker, t_cut, t_res), counts = counted(
                interrupted_then_resumed)
        finally:
            LOOP.train_step = real_step
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        # per fill batch and per eval batch one pass of the towers; per step
        # two passes of every micro-batch forward and one backward, the
        # blocked similarity three times each way; one more per evaluation:
        # the epoch's, and the final test on the best weights, which exist
        # only where the epoch's eval found a hit (mean R@1 > 0; at random
        # weights about six runs in seven)
        ev = rows("eval")
        if len(ev) != 1 or not 0 <= ev[0]["t2v"]["R1"] <= 100:
            raise SystemExit("no evaluation row in metrics.jsonl")
        has_best = os.path.exists(os.path.join(out_dir, "best.npz"))
        if has_best != (ev[0]["t2v"]["R1"] + ev[0]["v2t"]["R1"] > 0):
            raise SystemExit("best.npz and the eval's R@1 disagree")
        n_evals = 1 + has_best
        eval_batches = -(-n_test // args.batch_size_val)
        want = dict.fromkeys(kernel_wrappers(), 0)
        want.update({"K1": (n_steps + n_evals * eval_batches) * layers
                     + n_steps * 2 * n_micro * layers,
                     "K3": n_steps * n_micro * layers,
                     "K6": 3 * n_steps + n_evals, "K7": 3 * n_steps})
        print(f"  launches in the trainer's two runs: {counts} (expected "
              f"{want}: per step K1 = 2 x {n_micro} x {layers}, K3 = "
              f"{n_micro} x {layers}, K6 = K7 = 3; per fill or eval batch K1 "
              f"= {layers}; per evaluation K6 = 1)")
        if counts != want:
            raise SystemExit("launch counts do not match the trainer path")
        if sorted(k) != list(range(n_steps)):
            raise SystemExit(f"steps taken: {sorted(k)}")
        for i in range(n_steps):
            met = k[i]["metrics"]
            print(f"  step {i + 1}: " + " ".join(f"{n} {v:.5f}"
                                                  for n, v in met.items()))
            if not all(np.isfinite(v) for v in met.values()):
                raise SystemExit(f"non-finite metric at step {i + 1}")
        train_rows = rows("train")
        # the interrupted run leaves before it logs its last step
        if [r["step"] for r in train_rows] != \
                [s for s in range(1, n_steps + 1) if s != n_steps - 1]:
            raise SystemExit("metrics.jsonl does not hold the steps expected")
        for r in train_rows:
            if abs(r["loss"] - k[r["step"] - 1]["metrics"]["loss"]) > 1e-4:
                raise SystemExit("metrics.jsonl disagrees with the step")
        waits = [r["data_wait_s"] for r in train_rows]
        step_ms = [k[i]["ms"] for i in range(n_steps)]
        ms = statistics.median(step_ms)
        print(f"  steps {' / '.join(f'{t:.1f}' for t in step_ms)} ms, median "
              f"{ms:.1f} ms/step = {B / ms * 1e3:.2f} pairs/s on {card}; "
              f"loader wait before the logged steps "
              f"{' / '.join(f'{w:.3f}' for w in waits)} s through the "
              f"prefetch (before it: "
              f"{' / '.join(f'{w:.3f}' for w in EARLIER_LONG_WAITS)} s); peak "
              f"device memory {peak_gib:.2f} GiB; resumed run {t_res:.1f} s")
        h = h2d_times(_host_batch(m, B, 0))
        print(f"  one long batch, {h['bytes'] / 1e6:.1f} MB: {h2d_line(h)}")
        log = open(os.path.join(out_dir, "log.txt")).read()
        for line in log.splitlines():
            if "memory bank filled" in line or "Eval timing" in line:
                print("  " + line.split(": ", 1)[1])
        resumed = f"exact mid-epoch resume at batch {n_steps - 1}/{n_steps}"
        if resumed not in log:
            raise SystemExit(f"log.txt lacks '{resumed}'")
        if ("Final test on best" in log) != has_best:
            raise SystemExit("log.txt and best.npz disagree on the final test")
        print(f"  eval after step {ev[0]['step']}: t2v R@1 "
              f"{ev[0]['t2v']['R1']:.2f} R@5 {ev[0]['t2v']['R5']:.2f} R@10 "
              f"{ev[0]['t2v']['R10']:.2f} MedianR {ev[0]['t2v']['MR']:.1f}; "
              f"v2t R@1 {ev[0]['v2t']['R1']:.2f} R@5 {ev[0]['v2t']['R5']:.2f} "
              f"(random weights, {n_test} pairs; best mean R@1 "
              f"{tracker.best_mean_r1:.2f})")

        # the files, read back
        if state.step != n_steps or state.opt.step != n_steps:
            raise SystemExit(f"final state at step {state.step}")
        name = "clip.text_projection"
        final = {n: state.model.state_dict()[n].clone()
                 for n in TRAIN_COMPARED}
        with np.load(os.path.join(out_dir, "state_epoch0.npz")) as f:
            if int(f["step"]) != n_steps or int(f["opt_step"]) != n_steps:
                raise SystemExit("state_epoch0.npz holds the wrong step")
            saved = torch.as_tensor(f["params//clip//text//text_projection"])
            bank_ids = f["bank//ind"]
        if not torch.equal(saved, final[name].cpu()):
            raise SystemExit("state_epoch0.npz is not the final state")
        held = min(2 * B * n_steps, len(bank_ids))   # the fill, then the steps
        if (bank_ids[:held] < 0).any() or (bank_ids[held:] != -1).any():
            raise SystemExit("the saved bank is not fill + steps over empty")
        if has_best:
            best = weights_io.read_npz_params(os.path.join(out_dir,
                                                           "best.npz"))
            if not torch.equal(torch.as_tensor(best["clip"]["text"]
                                               ["text_projection"]),
                               final[name].cpu()):
                raise SystemExit("best.npz is not the evaluated weights")
            with open(os.path.join(out_dir, "best_metrics.json")) as f:
                if json.load(f)["best_mean_r1"] != tracker.best_mean_r1:
                    raise SystemExit("best_metrics.json disagrees")
        if ckpt.latest_resumable(out_dir) != os.path.join(
                out_dir, "state_epoch0.npz"):
            raise SystemExit("latest_resumable does not find the epoch state")
        for n in TRAIN_COMPARED:
            if torch.equal(final[n], start[n]):
                raise SystemExit(f"{n} did not move in {n_steps} steps")
        print(f"  state_preempt.npz, state_epoch0.npz"
              f"{', best.npz and best_metrics.json' if has_best else ''} read"
              f" back; {len(TRAIN_COMPARED)} compared parameters moved")

        if profile:
            from neighborretr_tpu_torch.data.datasets.synthetic import \
                make_synthetic_batch
            from neighborretr_tpu_torch.train import step as TS
            from torch.profiler import ProfilerActivity, profile as prof
            batch = TS.to_device(make_synthetic_batch(m, B, seed=9), "cuda")
            state.bank = state.bank._replace(
                feat_t=torch.randn_like(state.bank.feat_t),
                feat_v=torch.randn_like(state.bank.feat_v),
                mask_t=torch.ones_like(state.bank.mask_t),
                mask_v=torch.ones_like(state.bank.mask_v))
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as trace:
                TS.train_step(state, batch, cfg, 3 * n_steps,
                              LOOP.step_generator(0, 0, "cuda"))
                torch.cuda.synchronize()
            print("  profile of one long-token train step (device time by "
                  "kernel):")
            print(trace.key_averages().table(
                sort_by="cuda_time_total", row_limit=25,
                max_name_column_width=60))
            del batch
        del state
        shutil.move(os.path.join(out_dir, "state_preempt.npz"), carried)

        def reference_run(kernels, plain_similarity):
            """The same three steps in one run, from the same weights and
            batches, with the kernel runs' cluster ids and neighbour masks;
            the last step from the state the kernel runs took it from (their
            state_preempt.npz), so that every step of both is taken at the
            same weights, moments and bank → (per-step records, final
            compared parameters, s)."""
            from neighborretr_tpu_torch.models import neighborretr as M
            shutil.rmtree(out_dir, ignore_errors=True)
            rec = {}
            LOOP.train_step = instrumented(
                rec, replay={i: k[i]["decisions"] for i in k}, carry=carried)
            real_sim = M.local_similarity
            if plain_similarity:
                M.local_similarity = (
                    lambda model, tf, vf, tm, vm, kernels=True:
                    real_sim(model, tf, vf, tm, vm, False))
            try:
                t0 = time.perf_counter()
                st, _ = LOOP.run_training(
                    cfg, *cli.build_datasets(args, cfg), device="cuda",
                    kernels=kernels)
                seconds = time.perf_counter() - t0
            finally:
                LOOP.train_step, M.local_similarity = real_step, real_sim
            sd = st.model.state_dict()
            return rec, {n: sd[n].clone() for n in TRAIN_COMPARED}, seconds

        def held(label, rec, params, loss_tol, norm_tol, update_tol):
            """The kernel runs against a reference run: loss terms,
            gradient norms and parameter updates; tolerances by step."""
            failed = []
            for i in range(n_steps):
                a, b = k[i]["metrics"], rec[i]["metrics"]
                for n in LOSS_TERMS + ("grad_norm",):
                    tol = (norm_tol if n == "grad_norm" else loss_tol)[i]
                    rel = abs(a[n] - b[n]) / max(abs(b[n]), 1e-6)
                    ok = np.isfinite(b[n]) and rel <= tol
                    print(f"  step {i + 1} {n}: kernels"
                          f"{' (resumed)' if i == n_steps - 1 else ''} "
                          f"{a[n]:.6f} {label} {b[n]:.6f} rel {rel:.3g} "
                          f"(tolerance {tol:g}) {'ok' if ok else 'FAILED'}")
                    if not ok:
                        failed.append(f"step {i + 1} {n}")
            for name in TRAIN_COMPARED:
                dk = (final[name] - start[name]).float()
                dp = (params[name] - start[name]).float()
                rel = ((dk - dp).norm() / dp.norm().clamp_min(1e-30)).item()
                ok = rel <= update_tol
                print(f"  update of {name}: |Δ| {dp.norm().item():.4g}, "
                      f"kernels vs {label} rel L2 {rel:.3g} (tolerance "
                      f"{update_tol:g}) {'ok' if ok else 'FAILED'}")
                if not ok:
                    failed.append(f"update of {name}")
            if failed:
                raise SystemExit(f"the trainer's kernel runs disagree with the "
                                 f"{label} run: " + ", ".join(failed))

        print("  the same three steps in one run, step 3 from the kernel "
              "runs' state_preempt.npz, K1/K3 in the towers but the PLAIN "
              "blocked similarity (the same features reach K6/K7 and their "
              "plain version):")
        rec, params, seconds = reference_run(True, plain_similarity=True)
        held("plain-similarity", rec, params, *KP_TOL)
        print(f"  plain-similarity run: {seconds:.1f} s in all")
        del rec, params

        print("  the same three steps in one run, step 3 from the kernel "
              "runs' state_preempt.npz, through the plain versions of "
              "everything on the card:")
        p, params, t_plain = reference_run(False, plain_similarity=False)
        held("plain", p, params, *LONG_PLAIN_TOL)
        pms = statistics.median(p[i]["ms"] for i in p)
        print(f"  plain run: {t_plain:.1f} s in all, median {pms:.1f} "
              "ms/step")
        return counts, ms, pms
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        if os.path.exists(carried):
            os.remove(carried)


# the serving daemon (phase 16): 64 concurrent single-query clients, each
# round once through the lock and once behind the dispatcher, per index
# dtype; a 10,000-row index is MSR-VTT's whole corpus
DAEMON_CLIENTS, DAEMON_ROUNDS, DAEMON_N = 64, 3, 10_000
DAEMON_WORDS = ("man woman dog cat car street beach kitchen playing running "
                "cooking singing jumping red blue small large fast slow "
                "night").split()
# the bundle (the plain versions traced by torch.export) against the plain
# Searcher on the card: the same aten ops on the same inputs
BUNDLE_TOL = 1e-5


def _cli(module, *args, wait=True, timeout=600):
    """A CLI of the port as a subprocess on the card → its result, or (wait
    False) the running process with stderr piped."""
    cmd = [sys.executable, "-m", f"neighborretr_tpu_torch.cli.{module}",
           *map(str, args)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    if not wait:
        return subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stderr=subprocess.PIPE, text=True)
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode:
        raise SystemExit(f"cli.{module} failed ({r.returncode}):\n"
                         f"{r.stderr[-3000:]}")
    return r


def _http(port, method, path, body=None, timeout=120):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read().decode())
    conn.close()
    return out


def _same_hits(got, want, tol):
    """Top-k ids equal but for swaps between near-ties (scores within tol),
    scores within tol → the largest score difference."""
    worst = 0.0
    for g_row, w_row in zip(got, want):
        g_ids, g_s = zip(*g_row)
        w_ids, w_s = zip(*w_row)
        worst = max(worst, *(abs(a - b) for a, b in zip(g_s, w_s)))
        for r, (gi, wi) in enumerate(zip(g_ids, w_ids)):
            near = [abs(w_s[r] - s) <= tol for s in w_s]
            if gi != wi and near.count(True) < 2:
                raise SystemExit(f"rank {r}: {gi} where {wi} ranks alone")
    if worst > tol:
        raise SystemExit(f"scores {worst:.3g} apart (tolerance {tol:g})")
    return worst


def phase_serving_daemon(card: str):
    """The rest of the serving path at ViT-B/32 full width: (a) the index
    (with --append), serve, export_checkpoint and export CLIs as
    subprocesses; (b) make_server in this process against a 10,000-row
    index, lock-serialised and behind the BatchingDispatcher, fp16 and
    int8, a staged /reload mid-round; (c) the bundle with both packages
    blocked."""
    print("== phase 16: serving daemon (ViT-B/32 width, bf16, random "
          "weights): CLIs, HTTP load, reload, bundle")
    import shutil
    import signal
    import tempfile
    import threading

    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.cli.serve import make_server
    from neighborretr_tpu_torch.core import checkpoint as ckpt
    from neighborretr_tpu_torch.core.config import Config, ModelConfig
    from neighborretr_tpu_torch.data.tokenizer import ClipTokenizer
    from neighborretr_tpu_torch.models import weights_io

    t_phase = time.perf_counter()
    cfg = Config(model=ModelConfig())
    m = cfg.model
    model = weights_io.init_model(m, seed=0, device="cuda")
    tok = ClipTokenizer()
    work = tempfile.mkdtemp(prefix="chip_smoke_daemon_")
    procs = []
    try:
        weights = os.path.join(work, "weights.npz")
        ckpt.save_params(weights, model)
        ref_out = os.path.join(work, "reference.bin")
        procs.append(_cli("export_checkpoint", "--checkpoint", weights,
                          "--out", ref_out, wait=False))

        # (a) the CLIs
        idx = os.path.join(work, "index.npz")
        common = ["--datatype", "synthetic", "--out", idx, "--batch_size",
                  128, "--checkpoint", weights]
        t0 = time.perf_counter()
        _cli("index", "--synthetic_size", 256, *common)
        print(f"  cli.index: 256 videos in {time.perf_counter() - t0:.1f} s "
              "(process included)")
        serve = _cli("serve", "--index", idx, "--checkpoint", weights,
                     "--port", 0, wait=False)
        procs.append(serve)
        import queue
        lines = queue.Queue()      # its stderr, read to the end by a thread
        threading.Thread(target=lambda: [lines.put(ln) for ln in
                                         serve.stderr] + [lines.put("")],
                         daemon=True).start()
        port, log, deadline = None, [], time.monotonic() + 300
        while port is None:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0))
            except queue.Empty:
                raise SystemExit("cli.serve did not bind within 300 s:\n"
                                 + "".join(log[-30:]))
            if not line:
                raise SystemExit("cli.serve exited:\n" + "".join(log[-30:]))
            log.append(line)
            if "Serving on http://" in line:
                port = int(line.rsplit(":", 1)[1].split()[0])
        status, health = _http(port, "GET", "/healthz")
        status2, got = _http(port, "POST", "/search",
                             {"queries": ["a dog runs on the beach"],
                              "topk": 5})
        if (status, health["videos"], status2, len(got["results"][0])) != \
                (200, 256, 200, 5):
            raise SystemExit(f"cli.serve: {status} {health}, {status2} {got}")
        r = _cli("index", "--synthetic_size", 320, "--append", *common)
        for said in ("its 256 indexed videos are skipped",
                     "Appended 64 new videos"):
            if said not in r.stderr:
                raise SystemExit(f"cli.index --append did not log {said!r}:"
                                 f"\n{r.stderr[-2000:]}")
        status, out = _http(port, "POST", "/reload", timeout=600)
        _, health = _http(port, "GET", "/healthz")
        if (status, out.get("videos"), health["videos"]) != (200, 320, 320):
            raise SystemExit(f"/reload: {status} {out}, healthz {health}")
        serve.send_signal(signal.SIGINT)
        rc = serve.wait(timeout=120)
        print(f"  cli.serve --port 0: healthz 256 videos, a search, "
              f"cli.index --append (256 skipped, 64 appended), /reload and "
              f"healthz 320 videos, SIGINT exit {rc}")
        if rc != 0:
            raise SystemExit("cli.serve did not exit 0 on SIGINT")
        bundle_dir = os.path.join(work, "bundle")
        t0 = time.perf_counter()
        _cli("export", "--index", idx, "--checkpoint", weights, "--output",
             bundle_dir, "--query_batch", 8, "--topk", 5)
        print(f"  cli.export: bundle of 320 videos in "
              f"{time.perf_counter() - t0:.1f} s (process included)")
        if procs[0].wait(timeout=600) != 0:
            raise SystemExit("cli.export_checkpoint failed:\n"
                             + procs[0].stderr.read()[-2000:])
        sd = torch.load(ref_out)
        want = weights_io.reference_state_dict(model)
        if sorted(sd) != sorted(want) or not all(
                torch.equal(sd[k], want[k]) for k in want):
            raise SystemExit("cli.export_checkpoint: keys or tensors differ "
                             "from the model's reference state dict")
        print(f"  cli.export_checkpoint: {len(sd)} tensors under the "
              "reference's names, equal to the model's")

        # (b) load in this process
        rng = np.random.default_rng(0)
        F, E = m.max_frames, m.clip.embed_dim
        fp16 = {"video_ids": np.asarray([f"video{i}"
                                         for i in range(DAEMON_N)]),
                "v_feat": rng.normal(size=(DAEMON_N, F, E)).astype(
                    np.float16),
                "v_mask": np.ones((DAEMON_N, F), np.float32),
                "meta": np.frombuffer(json.dumps(serving._config_meta(
                    cfg, model)).encode(), dtype=np.uint8)}
        int8 = dict(fp16)
        int8["v_feat"], int8["v_scale"] = serving.quantize_features(
            fp16["v_feat"])
        queries = [" ".join(rng.choice(DAEMON_WORDS, size=8))
                   for _ in range(DAEMON_CLIENTS)]
        reload_path = serving.save_index(os.path.join(work, "big"), fp16)
        searchers = []

        def searcher(index, stage_rows=0, buckets=()):
            s = serving.Searcher(model, cfg, index, tok, query_batch=8,
                                 staged_upload_rows=stage_rows)
            s.warmup()
            for b in buckets:
                s.search(["warmup"] * b, topk=5)
            searchers.append(s)
            return s

        def rounds(srv, n, reload=False):
            """n rounds of DAEMON_CLIENTS concurrent single-query clients →
            (wall s, latencies ms, hits by query); with reload, one round
            with a POST /reload started after half the clients."""
            port = srv.server_address[1]
            lat, hits, failures = [], {}, []
            lock = threading.Lock()

            def one(i):
                try:
                    t0 = time.perf_counter()
                    status, out = _http(port, "POST", "/search",
                                        {"queries": [queries[i]],
                                         "topk": 5})
                    ms = 1e3 * (time.perf_counter() - t0)
                    if status != 200:
                        raise RuntimeError(f"{status} {out}")
                    with lock:
                        lat.append(ms)
                        hits.setdefault(queries[i], []).append(
                            [(h["video_id"], h["score"])
                             for h in out["results"][0]])
                except Exception as exc:     # counted, then fails the phase
                    failures.append(f"{type(exc).__name__}: {exc}")

            reloaded = []
            t0 = time.perf_counter()
            for _ in range(n):
                threads = [threading.Thread(target=one, args=(i,))
                           for i in range(DAEMON_CLIENTS)]
                half = DAEMON_CLIENTS // 2
                for t in threads[:half]:
                    t.start()
                if reload:
                    rel = threading.Thread(target=lambda: reloaded.append(
                        _http(port, "POST", "/reload", timeout=600)))
                    rel.start()
                for t in threads[half:]:
                    t.start()
                for t in threads:
                    t.join()
                if reload:
                    rel.join()
            wall = time.perf_counter() - t0
            if failures:
                raise SystemExit(f"{len(failures)} requests failed: "
                                 f"{failures[0]}")
            if reload and reloaded[0] != (200, {"status": "reloaded",
                                                "videos": DAEMON_N}):
                raise SystemExit(f"/reload under load: {reloaded[0]}")
            return wall, lat, hits

        def run(tag, index, dispatch, reload=False):
            s = searcher(index, buckets=(8, 16, 32, 64) if dispatch else ())
            d = (serving.BatchingDispatcher(s, max_batch=64, max_wait_ms=2.0)
                 if dispatch else None)
            reload_fn = None
            if reload:
                def reload_fn():
                    return searcher(serving.load_index(reload_path),
                                    stage_rows=512, buckets=d.buckets)
            srv = make_server(s, "127.0.0.1", 0, default_topk=5,
                              dispatcher=d, reload_fn=reload_fn)
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            try:
                calls0 = sum(x.calls for x in searchers)
                wall, lat, hits = rounds(srv, 1 if reload else DAEMON_ROUNDS,
                                         reload)
                calls = sum(x.calls for x in searchers) - calls0
            finally:
                srv.shutdown()
                srv.server_close()
                th.join(timeout=30)
                if d is not None:
                    d.close()
            n = len(lat)
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            extra = (f", {d.batches} dispatcher batches" if d else "")
            print(f"  {tag}: {n / wall:.1f} queries/s, p50 {p50:.3f} p95 "
                  f"{p95:.3f} p99 {p99:.3f} ms, {calls / n:.4f} device calls "
                  f"per request ({calls} for {n}{extra}) on {card}")
            if d is not None and not reload and calls != d.batches:
                raise SystemExit(f"{calls} device calls, {d.batches} batches")
            return s, hits, p99

        def load():
            out = {}
            for name, index in (("fp16", fp16), ("int8", int8)):
                for dispatch in (False, True):
                    tag = (f"{name}, "
                           f"{'dispatcher' if dispatch else 'lock'}")
                    out[tag] = run(tag, index, dispatch)
            out["reload"] = run("fp16, dispatcher, /reload (stage rows 512) "
                                "mid-round", fp16, True, reload=True)
            return out

        for x in searchers:
            x.calls = 0
        results, counts = counted(load)
        calls = sum(x.calls for x in searchers)
        want = dict.fromkeys(kernel_wrappers(), 0)
        want["K1"] = m.clip.transformer_layers * calls
        want["K2"] = calls
        print(f"  launches: {counts} for {calls} device calls (expected "
              f"K1 = {m.clip.transformer_layers} x calls, K2 = calls, every "
              "other 0)")
        if counts != want:
            raise SystemExit("launch counts do not match the daemon's path")
        worst = 0.0
        for tag, (s, hits, _) in results.items():
            for q, rows in hits.items():
                alone = s.search([q], topk=5)
                worst = max(worst, _same_hits(rows, alone * len(rows),
                                              SERVE_TOL[0]))
        print(f"  every response's top-5 is Searcher.search of its query "
              f"alone (near-ties aside), scores within {worst:.3g} "
              f"(tolerance {SERVE_TOL[0]:g})")
        print(f"  p99 of the round with a /reload: {results['reload'][2]:.3f}"
              f" ms; of the rounds without: "
              f"{results['fp16, dispatcher'][2]:.3f} ms")
        # the device call alone, without HTTP (host clock, synchronized)
        s = results["fp16, dispatcher"][0]
        for n in (1, 8, 64):
            direct = []
            for _ in range(7):
                t0 = time.perf_counter()
                s.search(queries[:n], topk=5)
                torch.cuda.synchronize()
                direct.append(1e3 * (time.perf_counter() - t0))
            print(f"  Searcher.search of {n} queries without HTTP: median "
                  f"{statistics.median(direct):.3f} ms of 7")

        # (c) the bundle, both packages blocked
        script = os.path.join(work, "load_bundle.py")
        with open(script, "w") as f:
            f.write(BUNDLE_LOADER)
        bundle_q = queries[:8]
        from neighborretr_tpu_torch.data.text import encode_caption
        enc = [encode_caption(tok, q, m.max_words) for q in bundle_q]
        np.save(os.path.join(work, "q_ids.npy"),
                np.stack([e[0] for e in enc]).astype(np.int32))
        np.save(os.path.join(work, "q_mask.npy"),
                np.stack([e[1] for e in enc]).astype(np.float32))
        r = subprocess.run([sys.executable, script, bundle_dir, work],
                           cwd=work, capture_output=True, text=True,
                           timeout=600)
        if r.returncode or "BUNDLE_OK" not in r.stdout:
            raise SystemExit(f"bundle loader failed:\n{r.stderr[-3000:]}")
        vals = np.load(os.path.join(work, "out_vals.npy"))
        ids = np.load(os.path.join(work, "out_idx.npy"))
        index320 = serving.load_index(idx)
        vid = [str(v) for v in index320["video_ids"]]
        got = [[(vid[j], float(v)) for j, v in zip(ir, vr)]
               for ir, vr in zip(ids, vals)]
        plain = serving.Searcher(model, cfg, index320, tok,
                                 kernels=False).search(bundle_q, topk=5)
        kern = serving.Searcher(model, cfg, index320, tok).search(bundle_q,
                                                                  topk=5)
        if [[v for v, _ in row] for row in got] != \
                [[v for v, _ in row] for row in plain]:
            raise SystemExit("the bundle's top-5 ids differ from the plain "
                             "Searcher's")
        err_plain = max(abs(a[1] - b[1]) for ra, rb in zip(got, plain)
                        for a, b in zip(ra, rb))
        if err_plain > BUNDLE_TOL:
            raise SystemExit(f"bundle vs plain Searcher: {err_plain:.3g}")
        err_k = _same_hits(got, kern, SERVE_TOL[0])
        print(f"  bundle in a process that can import neither package: top-5"
              f" ids equal to Searcher(kernels=False), scores within "
              f"{err_plain:.3g} (tolerance {BUNDLE_TOL:g}); within "
              f"{err_k:.3g} of the kernel Searcher (tolerance "
              f"{SERVE_TOL[0]:g}); {r.stdout.strip().splitlines()[-1]}")
        print(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
        return counts
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


# run as a script with both packages (and JAX) blocked: loads a bundle with
# torch.export.load, torch and numpy only, and saves its top-k
BUNDLE_LOADER = r"""
import json, os, sys, time

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("neighborretr_tpu", "neighborretr_tpu_torch",
                                  "jax"):
            raise ImportError(f"{name} imported by the bundle loader")
        return None
sys.meta_path.insert(0, _Block())

import numpy as np
import torch

d, work = sys.argv[1], sys.argv[2]
t0 = time.perf_counter()
meta = json.load(open(os.path.join(d, "meta.json")))
dev = torch.device(meta["platforms"][0])
program = torch.export.load(os.path.join(d, "query_program.pt2")).module()
with np.load(os.path.join(d, "params.npz"), allow_pickle=False) as z:
    leaves = [torch.as_tensor(z[k].astype(meta["param_dtypes"][k]),
                              device=dev) for k in sorted(z.files)]
with np.load(os.path.join(d, "index.npz"), allow_pickle=False) as z:
    index = {k: z[k] for k in z.files}
v_feat = index["v_feat"].astype(np.float32)
if "v_scale" in index:
    v_feat = v_feat * index["v_scale"].astype(np.float32)[..., None]
ids = np.load(os.path.join(work, "q_ids.npy"))
mask = np.load(os.path.join(work, "q_mask.npy"))
load_s = time.perf_counter() - t0
with torch.no_grad():
    vals, idx = program(leaves, torch.as_tensor(ids, device=dev),
                        torch.as_tensor(mask, device=dev),
                        torch.as_tensor(v_feat, device=dev),
                        torch.as_tensor(index["v_mask"].astype(np.float32),
                                        device=dev))
np.save(os.path.join(work, "out_vals.npy"), vals.cpu().numpy())
np.save(os.path.join(work, "out_idx.npy"), idx.cpu().numpy())
print("BUNDLE_OK")
print(f"bundle on {dev}: loaded in {load_s:.1f} s")
"""


# ---------------------------------------------------------------------------
# phase 17: data parallelism over torch.distributed
# ---------------------------------------------------------------------------

# (a) the train CLI at the MSR-VTT recipe on one rank over NCCL: a bank of
# 15 x 128 capacity, filled by the data's length (2 x 128), 2 steps, eval
DP_CLI_ARGV = [
    "--datatype", "synthetic", "--clip_checkpoint", "random",
    "--max_words", "24", "--max_frames", "12", "--batch_size", "128",
    "--mb_batch", "15", "--epochs", "1", "--synthetic_size", "256",
    "--batch_size_val", "128", "--n_display", "1", "--mid_epoch_eval", "0",
    "--workers", "8", "--seed", "42", "--num_devices", "1"]
# (b), (c): two ranks on the one card over gloo (NCCL refuses two ranks on
# one device) against one process over the same global batches, with that
# process's discrete decisions (DPC-KNN clusters, top-k masks) replayed:
# loss terms and gradient norms relative, the Adam first moment of the
# compared parameters (their gradient) and every parameter's update as a
# relative L2 distance per tensor, the bank's features as a relative L2
# distance over the whole bank.  The ranks encode 64 rows where the process
# encodes 128 (16 where 32 at the long shapes); on an H100 the features
# came out bit-equal (the bank: 0 apart), so what is left is the float
# atomics of torch's scatter-adds in the replicated loss code (CTM's
# index_add_), which differ from run to run: observed loss terms within
# 2.6e-7, gradient norms 3.6e-4, moments 8.7e-3 and updates 2.4e-2 (Adam's
# m / sqrt(v) enlarges a small gradient's noise); the tolerances below
# leave 3x and more above those.  Two kinds of tensor are counted but not
# held: one whose update in the one-process run stays within 4 ulps of its
# values everywhere (LayerNorm scales of the CLIP branch, whose learning
# rate is 1e-7), and a bias whose gradient is zero analytically: the last
# layer's of a token-weight net (`*_weight_fc.2.bias`, feeding a softmax
# over tokens) and a CTM's score bias (`*_ctm*.score.bias`, feeding an
# exp-weighted average over a cluster's tokens and the next block's
# attention softmax), neither of which changes when every logit moves by
# the same amount (but for the average's 1e-6 guard).  Such a bias receives
# rounding noise, which Adam's m / sqrt(v) scales to a full-size update of
# random sign (text_ctm1.score.bias: 0.1 and 0.2 rel L2 on an H100 in
# the two forms).
DP_LOSS_RTOL = 1e-4
DP_GRAD_NORM_RTOL = 5e-3
DP_MOMENT_REL_L2 = 0.03
DP_UPDATE_REL_L2 = 0.1
DP_BANK_REL_L2 = 1e-3
DP_FILL, DP_STEPS = 15, 2
DP_LONG_B, DP_LONG_STEPS = 32, 1
DP_TIMEOUT = 600


def dp_configs():
    """(MSR-VTT recipe, long recipe) configs: ViT-B/32 at full width and
    depth, bf16; batch 128 and bank 15 x 128, and 64 words x 64 frames at
    batch 32 and bank 15 x 32."""
    import dataclasses as dc

    from neighborretr_tpu_torch.core.config import Config
    short = Config()
    long = dc.replace(
        short, model=dc.replace(short.model, max_words=64, max_frames=64),
        data=dc.replace(short.data, max_words=64, max_frames=64),
        train=dc.replace(short.train, batch_size=DP_LONG_B))
    return short, long


def device_batch(m, B: int, seed: int):
    """A synthetic global batch made on the card from `seed` (the same bits
    in every process on the card): ragged captions ending in the EOT id,
    uint8 frames."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    W, F, R = m.max_words, m.max_frames, m.clip.image_resolution
    vocab = m.clip.vocab_size
    lens = torch.randint(4, W + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(W, device="cuda")[None] < lens[:, None]).float()
    ids = torch.randint(1, vocab - 1, (B, W), generator=g, device="cuda",
                        dtype=torch.int32) * mask.int()
    ids[torch.arange(B, device="cuda"), lens - 1] = vocab - 1
    return {"text_ids": ids, "text_mask": mask,
            "video": torch.randint(0, 256, (B, F, R, R, 3), generator=g,
                                   device="cuda", dtype=torch.uint8),
            "video_mask": torch.ones(B, F, device="cuda"),
            "idx": torch.arange(B, dtype=torch.int32, device="cuda")
            + B * seed}


def dp_run(cfg, n_steps: int, mesh=None, replay=None, seed0: int = 100):
    """Bank fill (DP_FILL batches) and n_steps steps from init_model(seed=0)
    on this process's block of each global batch → record: per step the
    metrics, ms and decisions; launch counts; the final parameters, the
    compared parameters' first moments and the bank on the host; a hash of
    the parameters."""
    import hashlib

    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    m, B = cfg.model, cfg.train.batch_size
    model = init_model(m, seed=0, device="cuda")
    if mesh is not None:
        pmesh.replicate(model, mesh)

    def block(b):
        return pmesh.batch_block(b, mesh) if mesh is not None else b

    rec = dict(metrics=[], ms=[], decisions=[])

    def run():
        bank = MB.create(cfg.train.memory_bank_capacity, m.max_words,
                         m.max_frames, m.width, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DP_FILL):
            bank = TS.fill_bank_step(model, bank, block(device_batch(
                m, B, seed0 + i)), cfg, i * B, mesh=mesh)
        torch.cuda.synchronize()
        rec["fill_s"] = time.perf_counter() - t0
        state = TS.create_train_state(model, bank)
        for i in range(n_steps):
            batch = block(device_batch(m, B, seed0 + DP_FILL + i))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the DPC-KNN tie-break draws: the same generator state on
            # every rank (and in the one process) at each step
            gen = torch.Generator(device="cuda").manual_seed(1000 + i)
            log = []
            with decisions(log, replay[i] if replay and i < len(replay)
                           else None):
                state, met = TS.train_step(state, batch, cfg, 30, gen,
                                           mesh=mesh)
            torch.cuda.synchronize()
            rec["ms"].append(1e3 * (time.perf_counter() - t0))
            rec["decisions"].append(log)
            rec["metrics"].append({k: v.item() for k, v in met.items()})
        return state

    torch.cuda.reset_peak_memory_stats()
    state, rec["counts"] = counted(run)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    params = dict(model.named_parameters())
    rec["params"] = {n: p.detach().cpu() for n, p in params.items()}
    rec["moments"] = {n: state.opt.m[n].cpu() for n in TRAIN_COMPARED}
    rec["bank"] = [t.cpu() for t in state.bank]
    rec["hash"] = hashlib.sha256(b"".join(
        rec["params"][n].numpy().tobytes() for n in sorted(params))
        + b"".join(state.opt.m[n].cpu().numpy().tobytes()
                   for n in sorted(params))).hexdigest()
    del model, state, params
    torch.cuda.empty_cache()
    return rec


def dp_rank_worker(rank: int, port: int, work: str) -> None:
    """One rank of phase 17's (b) and (c): gloo over localhost with the
    tensors on the card, the forms in turn, results to work/rank{r}.pt."""
    import torch.distributed as dist

    from neighborretr_tpu_torch.ops import _build
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    _build.load(*LIBS)                 # built by the parent: loads only
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    mesh = pmesh.make_mesh("cuda:0")
    plan = torch.load(os.path.join(work, "plan.pt"), map_location="cuda:0",
                      weights_only=False)
    short, long = dp_configs()
    import dataclasses as dc
    out = {}
    for form, cfg, steps in (("gathered", short, DP_STEPS),
                             ("explicit", short, DP_STEPS),
                             ("long_explicit", long, DP_LONG_STEPS)):
        cfg = dc.replace(cfg, train=dc.replace(
            cfg.train, explicit_spmd=form != "gathered"))
        rec = dp_run(cfg, steps, mesh, plan["long" if form == "long_explicit"
                                            else "short"])
        rec.pop("decisions")
        if rank:
            rec = {k: rec[k] for k in ("counts", "hash", "ms", "metrics")}
        out[form] = rec
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


DP_BARS = (DP_LOSS_RTOL, DP_GRAD_NORM_RTOL, DP_MOMENT_REL_L2,
           DP_UPDATE_REL_L2, DP_BANK_REL_L2)


def held_readings(got, want, start):
    """got's differences from want, two records of the same steps from the
    parameters `start` → ({(kind, name): reading}, the counts of updates
    left out).  kind "loss" (name "step i term") and "grad_norm" ("step
    i"): relative; "moment": rel L2 of a compared parameter's first moment;
    "update": rel L2 of a parameter's update, leaving out those within 4
    ulps of their values and the biases with an analytically zero gradient;
    "bank": rel L2 of the bank's text or video features."""
    out = {}
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        for n in LOSS_TERMS + ("grad_norm",):
            rel = abs(a[n] - b[n]) / max(abs(b[n]), 1e-6)
            kind = "grad_norm" if n == "grad_norm" else "loss"
            out[kind, f"step {i + 1} {n}"] = (rel if np.isfinite(a[n])
                                              else math.inf)
    for n in TRAIN_COMPARED:
        out["moment", n] = _rel_l2(got["moments"][n], want["moments"][n])
    below = invariant = 0
    for n, p0 in start.items():
        if n.endswith(("_weight_fc.2.bias", "_weight_fc1.2.bias",
                       ".score.bias")):
            invariant += 1
            continue
        dw = want["params"][n] - p0
        ulp = torch.finfo(torch.float32).eps * p0.abs().max().clamp_min(
            1e-30)
        if dw.abs().max() <= 4 * ulp:
            below += 1
            continue
        out["update", n] = _rel_l2(got["params"][n] - p0, dw)
    for name, i in (("text", 1), ("video", 2)):
        out["bank", name] = _rel_l2(got["bank"][i], want["bank"][i])
    return out, (below, invariant)


# a witness's reading times this is a quantity's bar (never below the
# strategy's own); a loss term's bar never above phase 8's ceiling
FLOOR_FOLD = 4
LOSS_CEIL = 1e-2


def dp_held(label, got, want, start, bars=DP_BARS, phase=17, floor=None,
            verbose=True):
    """Two ranks' record against one process's: loss terms, gradient norms,
    compared moments, every parameter's update, the bank; `bars`: (loss
    terms, gradient norms, moments, updates, bank), phase 17's by default.
    floor: held_readings of a witness, two correct one-process records
    that round otherwise; each quantity's bar is then the larger of its
    `bars` entry and FLOOR_FOLD times the witness's reading for it (a loss
    term's at most LOSS_CEIL).  verbose=False prints nothing but the
    failure it raises."""
    base = dict(zip(("loss", "grad_norm", "moment", "update", "bank"), bars))
    got_r, (below, invariant) = held_readings(got, want, start)
    wit = floor[0] if floor is not None else {}

    def bar(q):
        b = base[q[0]]
        if q in wit:
            b = max(b, FLOOR_FOLD * wit[q])
            if q[0] == "loss":
                b = min(b, LOSS_CEIL)
        return b

    def witness(q):
        return f", witness {wit[q]:.3g}" if q in wit else ""

    failed = [q[1] if q[0] in ("loss", "grad_norm") else f"{q[0]} of {q[1]}"
              for q, r in got_r.items() if not r <= bar(q)]
    ind, ft, fv, mt, mv = got["bank"]
    if not (torch.equal(ind, want["bank"][0]) and torch.equal(
            mt, want["bank"][3]) and torch.equal(mv, want["bank"][4])):
        failed.append("bank ids or masks")
    if not verbose:
        if failed:
            raise SystemExit(f"phase {phase} {label}: " + ", ".join(failed))
        return
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        for n in LOSS_TERMS + ("grad_norm",):
            q = ("grad_norm" if n == "grad_norm" else "loss",
                 f"step {i + 1} {n}")
            print(f"  {label} step {i + 1} {n}: two ranks {a[n]:.6f} one "
                  f"process {b[n]:.6f} rel {got_r[q]:.3g} (tolerance "
                  f"{bar(q):.3g}{witness(q)}) "
                  f"{'ok' if got_r[q] <= bar(q) else 'FAILED'}")

    def worst(kind, k=1):
        qs = sorted((q for q in got_r if q[0] == kind),
                    key=lambda q: got_r[q] / bar(q), reverse=True)
        return ", ".join(f"{q[1]} {got_r[q]:.3g} (tolerance {bar(q):.3g}"
                         f"{witness(q)})" for q in qs[:k])

    print(f"  {label} Adam first moments of the {len(TRAIN_COMPARED)} "
          f"compared parameters, nearest their tolerance: "
          f"{worst('moment', 2)}")
    n_upd = sum(q[0] == "update" for q in got_r)
    print(f"  {label} updates: {n_upd} parameters held, {below} within 4 "
          f"ulps of their values and {invariant} biases with an "
          f"analytically zero gradient not held; nearest their tolerance: "
          f"{worst('update', 3)}")
    for name, a, b in (("text", ft, want["bank"][1]),
                       ("video", fv, want["bank"][2])):
        q = ("bank", name)
        print(f"  {label} bank {name} features: rel L2 {got_r[q]:.3g}, max "
              f"abs {(a - b).abs().max().item():.3g} (tolerance "
              f"{bar(q):.3g}{witness(q)}); ids and masks "
              f"{'equal' if 'bank ids or masks' not in failed else 'DIFFER'}")
    if failed:
        raise SystemExit(f"phase {phase} {label}: the ranks disagree with "
                         "one process: " + ", ".join(failed))


def phase_data_parallel(card: str, train_ms=None, train_peak=None):
    """(a) the train CLI at --num_devices 1 over NCCL, (b) two ranks on the
    card in both forms against one process, (c) the long recipe's explicit
    form the same way, (d) a two-shard Searcher against one shard →
    launch counts by path.  train_ms / train_peak: phase 8's step time and
    peak memory, printed beside (a)'s (None when phase 8 did not run)."""
    print("== phase 17: data parallel (torch.distributed; ViT-B/32 width, "
          "bf16, depth not cut)")
    import shutil
    import socket
    import tempfile

    import torch.distributed as dist

    from neighborretr_tpu_torch.cli import train as cli
    from neighborretr_tpu_torch.train import loop as LOOP
    t_phase = time.perf_counter()
    paths = {}

    # (a)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    argv = DP_CLI_ARGV + ["--output_dir", out_dir]
    cfg = cli.build_config(cli.parse_args(argv))
    m = cfg.model
    layers = (m.clip.vision_layers + m.clip.transformer_layers
              + m.temporal_layers)
    inits, step_ms = [], []
    real_init, real_step = dist.init_process_group, LOOP.train_step

    def init(backend=None, *a, **kw):
        inits.append((backend, kw.get("world_size")))
        return real_init(backend, *a, **kw)

    def step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    try:
        dist.init_process_group, LOOP.train_step = init, step
        torch.cuda.reset_peak_memory_stats()
        (state, tracker), counts = counted(lambda: cli.main(argv))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        dist.init_process_group, LOOP.train_step = real_init, real_step
    try:
        print(f"  (a) {' '.join(argv[:-2])}")
        if inits != [("nccl", 1)] or dist.is_initialized():
            raise SystemExit(f"the CLI's process group: {inits} (expected "
                             "one NCCL group of world size 1, destroyed at "
                             "the end)")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(r) for r in f]
        ev = [r for r in rows if r["kind"] == "eval"]
        has_best = os.path.exists(os.path.join(out_dir, "best.npz"))
        n_evals = len(ev) + has_best
        n_fill = min(cfg.train.mb_batch, 256 // 128)
        want = dict.fromkeys(kernel_wrappers(), 0)
        want.update({"K1": (n_fill + 2 + n_evals) * layers,
                     "K3": 2 * layers, "K4": 4, "K5": 4, "K2": n_evals})
        print(f"  (a) init_process_group {inits}; launches {counts} "
              f"(expected {want}: per step K1 = K3 = {layers}, K4 = K5 = 2; "
              f"per fill or eval batch K1 = {layers}; per evaluation K2 = 1)")
        if counts != want:
            raise SystemExit("phase 17 (a): launch counts do not match the "
                             "train CLI's path")
        train = [r for r in rows if r["kind"] == "train"]
        if [r["step"] for r in train] != [1, 2] or not all(
                np.isfinite(r[k]) for r in train for k in LOSS_TERMS):
            raise SystemExit("phase 17 (a): the steps' metrics")
        if state.step != 2 or not ev:
            raise SystemExit("phase 17 (a): the run's end state")
        beside = (f"phase 8's median {train_ms:.1f} ms/step and peak "
                  f"{train_peak:.2f} GiB" if train_ms is not None
                  else "phase 8 not run in this call")
        print(f"  (a) steps {' / '.join(f'{t:.1f}' for t in step_ms)} ms "
              f"(the first with the NCCL group's warm-up), peak device "
              f"memory {peak:.2f} GiB; against {beside}; eval t2v R@1 "
              f"{ev[0]['t2v']['R1']:.2f} (random weights) on {card}")
        paths["dp_cli"] = counts
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del state, tracker
    torch.cuda.empty_cache()

    # (b), (c): one process first, its decisions recorded
    short, long = dp_configs()
    from neighborretr_tpu_torch.models.weights_io import init_model
    start = {n: p.detach().cpu() for n, p in init_model(
        short.model, 0, "cuda").named_parameters()}
    torch.cuda.empty_cache()
    ref = {"short": dp_run(short, DP_STEPS), "long": dp_run(long,
                                                            DP_LONG_STEPS)}
    long_start = {n: p.detach().cpu() for n, p in init_model(
        long.model, 0, "cuda").named_parameters()}
    torch.cuda.empty_cache()
    wb = dict.fromkeys(kernel_wrappers(), 0)
    wb.update({"K1": (DP_FILL + DP_STEPS) * layers, "K3": DP_STEPS * layers,
               "K4": 2 * DP_STEPS, "K5": 2 * DP_STEPS})
    wl = dict.fromkeys(kernel_wrappers(), 0)
    wl.update({"K1": (DP_FILL + DP_LONG_STEPS) * layers,
               "K3": DP_LONG_STEPS * layers, "K6": 3 * DP_LONG_STEPS,
               "K7": 3 * DP_LONG_STEPS})
    for key, want in (("short", wb), ("long", wl)):
        r = ref[key]
        print(f"  one process, {key}: fill {r['fill_s']:.2f} s, steps "
              f"{' / '.join(f'{t:.1f}' for t in r['ms'])} ms, peak "
              f"{r['peak_gib']:.2f} GiB, launches {r['counts']}")
        if r["counts"] != want:
            raise SystemExit(f"phase 17: the one-process {key} run's "
                             f"launches, expected {want}")
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_ranks_")
    procs = []
    try:
        torch.save({k: r["decisions"] for k, r in ref.items()},
                   os.path.join(work, "plan.pt"))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
             str(port), work], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=DP_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                raise SystemExit(f"phase 17: a rank did not finish in "
                                 f"{DP_TIMEOUT} s")
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise SystemExit(f"phase 17: rank {r} failed:\n{log[-4000:]}")
        print(f"  two ranks (two processes on {card}, gloo with the tensors "
              f"on the card) ran all three forms in "
              f"{time.perf_counter() - t0:.1f} s, processes included")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)

    we = dict(wb, K4=0, K2=2 * DP_STEPS)
    for form, want, key, st in (
            ("gathered", wb, "short", start),
            ("explicit", we, "short", start),
            ("long_explicit", wl, "long", long_start)):
        r0, r1 = ranks[0][form], ranks[1][form]
        label = {"gathered": "(b) gathered", "explicit": "(b) explicit",
                 "long_explicit": "(c) long explicit"}[form]
        print(f"  {label}: launches per rank {r0['counts']} / {r1['counts']}"
              f" (expected {want}); steps {' / '.join(f'{t:.1f}' for t in r0['ms'])}"
              f" ms on rank 0 of two on one card: not a scale-out number; "
              f"fill {r0['fill_s']:.2f} s; peak {r0['peak_gib']:.2f} GiB a "
              "rank")
        if r0["counts"] != want or r1["counts"] != want:
            raise SystemExit(f"phase 17 {label}: launch counts")
        if r0["hash"] != r1["hash"]:
            raise SystemExit(f"phase 17 {label}: the ranks' parameters or "
                             "moments differ")
        # the loss terms come from each rank's own run of the replicated
        # loss code, whose float atomics (torch's scatter-adds) may round
        # otherwise from run to run; the gradient norm is the all-reduced
        # gradients'
        gap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                  for a, b in zip(r0["metrics"], r1["metrics"]) for k in a)
        print(f"  {label}: parameters and moments bit-equal across the "
              f"ranks (sha256 {r0['hash'][:16]}...); the ranks' metrics "
              f"differ by at most {gap:.3g} relative")
        dp_held(label, r0, ref[key], st)
        paths[f"dp_{form}_two_ranks"] = {
            k: r0["counts"][k] + r1["counts"][k] for k in r0["counts"]}
    del ref, ranks, start, long_start

    # (d) the corpus in two shards on the one card against one shard
    from neighborretr_tpu_torch import serving
    from neighborretr_tpu_torch.data.tokenizer import ClipTokenizer
    model = init_model(short.model, 0, "cuda")
    rng = np.random.default_rng(3)
    F, E = short.model.max_frames, short.model.clip.embed_dim
    index = {"video_ids": np.asarray([f"video{i}" for i in range(DAEMON_N)]),
             "v_feat": rng.normal(size=(DAEMON_N, F, E)).astype(np.float16),
             "v_mask": (np.arange(F)[None] < rng.integers(
                 1, F + 1, DAEMON_N)[:, None]).astype(np.float32),
             "meta": np.frombuffer(json.dumps(serving._config_meta(
                 short, model)).encode(), dtype=np.uint8)}
    tok = ClipTokenizer()
    queries = [" ".join(rng.choice(DAEMON_WORDS, size=8)) for _ in range(64)]
    one = serving.Searcher(model, short, index, tok, query_batch=8)
    two = serving.Searcher(model, short, index, tok, query_batch=8,
                           devices=["cuda:0", "cuda:0"])
    one.warmup()
    two.warmup()
    hits, counts = counted(lambda: two.search(queries, topk=5))
    want = dict.fromkeys(kernel_wrappers(), 0)
    want.update({"K1": m.clip.transformer_layers, "K2": 2})
    print(f"  (d) Searcher over {DAEMON_N} videos in 2 shards on [cuda:0, "
          f"cuda:0], 64 queries: launches {counts} (expected {want}: K2 once "
          "a shard)")
    if counts != want:
        raise SystemExit("phase 17 (d): launch counts")
    base = one.search(queries, topk=5)
    ids_equal = [[v for v, _ in a] for a in hits] == \
        [[v for v, _ in b] for b in base]
    diff = max(abs(s - t) for a, b in zip(hits, base)
               for (_, s), (_, t) in zip(a, b))
    sim_equal = np.array_equal(two.similarities(queries),
                               one.similarities(queries))
    def request_ms(searcher):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            searcher.search(queries, topk=5)
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    ms1, ms2 = request_ms(one), request_ms(two)
    print(f"  (d) top-5 ids equal to one shard's: {ids_equal}; largest score "
          f"difference {diff:.3g}; the [64, {DAEMON_N}] similarity bit-equal:"
          f" {sim_equal}; {ms2:.3f} ms a request in two shards, {ms1:.3f} ms "
          f"in one (median of 5, host clock around the synchronised call) on "
          f"{card}")
    if not ids_equal or diff != 0.0 or not sim_equal:
        raise SystemExit("phase 17 (d): the sharded Searcher disagrees with "
                         "one shard")
    paths["sharded_serving"] = counts
    print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# phase 18: real inputs.  MSR-VTT's layout at the recipe's widths: 64 train
# videos x 2 captions (4 steps at batch 32), 16 test videos, clips of 12 s
# at 320 x 240 written with cv2 (mp4v); a seeded random ViT-B/32 in OpenAI's
# layout (TorchScript, fp16) as the CLIP checkpoint
REAL_TRAIN, REAL_TEST, REAL_SECONDS, REAL_FPS = 64, 16, 12, 10
REAL_SIZE = (320, 240)
REAL_ARCHIVE_SEED = 18
REAL_ARGV = [
    "--datatype", "msrvtt", "--epochs", "1", "--batch_size", "32",
    "--batch_size_val", "16", "--mb_batch", "2", "--max_frames", "12",
    "--max_words", "24", "--augment_backend", "native", "--n_display", "1",
    "--mid_epoch_eval", "0", "--workers", "8", "--seed", "42"]
REAL_QUERY = "a clip showing scene 70"


def _write_real_clip(path: str, seed: int):
    """An encoded clip of REAL_SECONDS at REAL_SIZE: a per-video gradient
    and a square of its own colour moving across it."""
    import cv2
    w, h = REAL_SIZE
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             REAL_FPS, (w, h))
    if not writer.isOpened():
        raise SystemExit("cv2 cannot write mp4v here")
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tint = rng.integers(0, 256, 3).astype(np.float32)
    base = (0.5 * tint + 0.5 * np.stack(
        [xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], -1)
            ).astype(np.uint8)
    side = int(rng.integers(32, 96))
    color = rng.integers(0, 256, 3).astype(np.uint8)
    pos, vel = rng.uniform(0, 1, 2), rng.uniform(-0.03, 0.03, 2)
    for i in range(REAL_SECONDS * REAL_FPS):
        x, y = np.abs((pos + vel * i + 1) % 2 - 1)      # bounce in [0, 1]
        x, y = int(x * (w - side)), int(y * (h - side))
        frame = base.copy()
        frame[y:y + side, x:x + side] = color
        writer.write(frame)
    writer.release()


def _write_msrvtt_tree(root: str):
    """MSR-VTT's annotation files (train csv, caption json, JSFUSION test
    csv) and the clips → (anno_path, video_path)."""
    import concurrent.futures as cf
    import csv
    anno, videos = os.path.join(root, "anns"), os.path.join(root, "videos")
    os.makedirs(anno)
    os.makedirs(videos)
    n = REAL_TRAIN + REAL_TEST
    with cf.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: _write_real_clip(
            os.path.join(videos, f"video{i}.mp4"), i), range(n)))
    with open(os.path.join(anno, "MSRVTT_train.9k.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["video_id"])
        w.writeheader()
        for i in range(REAL_TRAIN):
            w.writerow({"video_id": f"video{i}"})
    sentences = []
    for i in range(REAL_TRAIN):
        sentences += [{"video_id": f"video{i}",
                       "caption": f"a square moves across scene {i}"},
                      {"video_id": f"video{i}",
                       "caption": f"someone films a coloured block {i}"}]
    with open(os.path.join(anno, "MSRVTT_data.json"), "w") as f:
        json.dump({"sentences": sentences}, f)
    with open(os.path.join(anno, "MSRVTT_JSFUSION_test.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["video_id", "sentence"])
        w.writeheader()
        for i in range(REAL_TRAIN, n):
            w.writerow({"video_id": f"video{i}",
                        "sentence": f"a clip showing scene {i}"})
    return anno, videos


def phase_real_inputs(card: str):
    """The port's input side at ViT-B/32 width: an OpenAI-layout CLIP
    archive, encoded clips in MSR-VTT's layout, cli.pack_dataset,
    cli.train from the archive on the packs, cli.eval from best.npz and
    from the best.pth cli.export_checkpoint writes of it, cli.index and
    cli.search → launch counts by path."""
    print("== phase 18: real inputs (ViT-B/32 width, bf16, an OpenAI-layout "
          "CLIP archive, encoded MSR-VTT-layout clips)")
    import io
    import shutil
    import tempfile

    from neighborretr_tpu_torch.cli import eval as cli_eval
    from neighborretr_tpu_torch.cli import export_checkpoint as cli_export
    from neighborretr_tpu_torch.cli import index as cli_index
    from neighborretr_tpu_torch.cli import pack_dataset as cli_pack
    from neighborretr_tpu_torch.cli import search as cli_search
    from neighborretr_tpu_torch.cli import train as cli
    from neighborretr_tpu_torch.core.config import ClipConfig
    from neighborretr_tpu_torch.models.weights_io import NON_PARAMETER_KEYS
    from neighborretr_tpu_torch.tools import clip_archive as CA
    from neighborretr_tpu_torch.train import loop as LOOP
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_real_")
    paths = {}
    try:
        # 1. the CLIP archive
        t0 = time.perf_counter()
        clip = ClipConfig()
        archive = os.path.join(root, "ViT-B-32-random.pt")
        CA.save_openai_archive(CA.random_openai_state_dict(
            clip, REAL_ARCHIVE_SEED), clip, archive)
        print(f"  ViT-B/32 archive (TorchScript, fp16, seed "
              f"{REAL_ARCHIVE_SEED}): {os.path.getsize(archive) / 1e6:.1f} "
              f"MB in {time.perf_counter() - t0:.1f} s")
        # 2. the clips and annotations
        t0 = time.perf_counter()
        anno, videos = _write_msrvtt_tree(root)
        n_videos = REAL_TRAIN + REAL_TEST
        mb = sum(os.path.getsize(os.path.join(videos, f))
                 for f in os.listdir(videos)) / 1e6
        print(f"  {n_videos} clips of {REAL_SECONDS} s at {REAL_SIZE[0]} x "
              f"{REAL_SIZE[1]}, {REAL_FPS} fps ({mb:.1f} MB, mp4v) and "
              f"MSR-VTT's annotation files written in "
              f"{time.perf_counter() - t0:.1f} s")
        data = ["--anno_path", anno, "--video_path", videos]
        # 3. the packs
        packed = os.path.join(root, "packed")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_pack.main(["--datatype", "msrvtt", *data,
                                "--output_dir", packed, "--max_frames", "12",
                                "--resolution", str(clip.image_resolution),
                                "--workers", "8"])
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"  cli.pack_dataset: {summary}")
        if rc != 0 or summary["packed_clips"] != n_videos or \
                summary["empty_clips"]:
            raise SystemExit("pack_dataset did not pack every clip")
        pack_ms = summary["decode_ms_per_clip_wall"]

        # 4. the train CLI from the archive on the packs
        argv = REAL_ARGV + data + ["--clip_checkpoint", archive]
        args = cli.parse_args(argv + ["--output_dir", root])
        cfg = cli.build_config(args)
        m, B = cfg.model, cfg.train.batch_size
        layers = (m.clip.vision_layers + m.clip.transformer_layers
                  + m.temporal_layers)
        n_steps = 2 * REAL_TRAIN // B
        n_fill = min(cfg.train.mb_batch, n_steps)
        real_step = LOOP.train_step

        def instrumented(rec, first=False):
            def step(state, batch, *a):
                log = None
                if first and state.step == 0:
                    rec["first"] = dict(
                        weights={k: v.clone() for k, v
                                 in state.model.state_dict().items()},
                        bank=tuple(t.clone() for t in state.bank),
                        batch={k: v.clone() for k, v in batch.items()},
                        args=a)
                    log = rec["first"]["decisions"] = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (decisions(log) if log is not None
                      else contextlib.nullcontext()):
                    state, met = real_step(state, batch, *a)
                torch.cuda.synchronize()
                rec.setdefault("ms", []).append(
                    1e3 * (time.perf_counter() - t0))
                rec.setdefault("metrics", []).append(
                    {k: v.item() for k, v in met.items()})
                return state, met
            return step

        def train(out, rec, first, extra=()):
            LOOP.train_step = instrumented(rec, first)
            try:
                t0 = time.perf_counter()
                result = cli.main(argv + list(extra) + ["--output_dir", out])
                rec["s"] = time.perf_counter() - t0
            finally:
                LOOP.train_step = real_step
            with open(os.path.join(out, "metrics.jsonl")) as f:
                rows = list(map(json.loads, f))
            rec["waits"] = [r["data_wait_s"] for r in rows
                            if r["kind"] == "train"]
            rec["evals"] = [r for r in rows if r["kind"] == "eval"]
            return result

        run_dir = os.path.join(root, "run")
        print(f"  cli.train {' '.join(REAL_ARGV)} --clip_checkpoint <archive>"
              f" --packed_dir <packs>: {n_steps} steps, fill of {n_fill} "
              f"batches, {layers} attention sublayers per pass")
        k = {}
        (state, tracker), counts = counted(lambda: train(
            run_dir, k, True, ["--packed_dir", packed]))
        ev = k["evals"]
        if len(ev) != 1:
            raise SystemExit("no evaluation row in metrics.jsonl")
        has_best = os.path.exists(os.path.join(run_dir, "best.npz"))
        if has_best != (ev[0]["t2v"]["R1"] + ev[0]["v2t"]["R1"] > 0):
            raise SystemExit("best.npz and the eval's R@1 disagree")
        n_evals = 1 + has_best
        want = dict.fromkeys(kernel_wrappers(), 0)
        want.update({"K1": (n_fill + n_steps + n_evals) * layers,
                     "K3": n_steps * layers, "K4": 2 * n_steps,
                     "K5": 2 * n_steps, "K2": n_evals})
        print(f"  launches in the train run: {counts} (expected {want}: per "
              f"step K1 = K3 = {layers}, K4 = K5 = 2; per fill or eval batch "
              f"K1 = {layers}; per evaluation K2 = 1)")
        if counts != want:
            raise SystemExit("launch counts do not match the real-input "
                             "train path")
        paths["real_inputs_train"] = counts
        for i, met in enumerate(k["metrics"]):
            print(f"  step {i + 1}: " + " ".join(f"{n} {v:.5f}"
                                                  for n, v in met.items()))
            if not all(np.isfinite(v) for v in met.values()):
                raise SystemExit(f"non-finite metric at step {i + 1}")
        if len(k["metrics"]) != n_steps:
            raise SystemExit(f"the run took {len(k['metrics'])} steps")
        t2v = ev[0]["t2v"]
        print(f"  eval: t2v R@1 {t2v['R1']:.2f} R@5 {t2v['R5']:.2f} R@10 "
              f"{t2v['R10']:.2f}, v2t R@1 {ev[0]['v2t']['R1']:.2f} (random "
              f"weights, {REAL_TEST} test videos)")
        if not all(np.isfinite(v) for d in ("t2v", "v2t")
                   for v in ev[0][d].values()):
            raise SystemExit("non-finite R@K")

        # the weights the first step started from: the archive's CLIP, the
        # temporal tower seeded from its text tower
        first = k["first"]
        w = first["weights"]
        arch = torch.jit.load(archive, map_location="cpu").state_dict()
        worst, n_clip = 0.0, 0
        for name, t in arch.items():
            if name in NON_PARAMETER_KEYS:
                continue
            got = w["clip." + name].cpu()
            worst = max(worst, (got - t.float().reshape(got.shape)).abs()
                        .max().item())
            n_clip += 1
        own = sum(1 for n in w if n.startswith("clip."))
        print(f"  model.clip at step 1 vs the archive read by torch.jit.load"
              f" (fp16 -> fp32): {n_clip} of {own} tensors, max |diff| "
              f"{worst:g} (must be 0)")
        if worst != 0.0 or n_clip != own:
            raise SystemExit("model.clip is not the archive's CLIP")
        seeded = all(torch.equal(
            w[f"transformerClip.resblocks.{i}.{rest}"],
            w[f"clip.transformer.resblocks.{i}.{rest}"])
            for i in range(m.temporal_layers)
            for rest in ("ln_1.weight", "attn.in_proj_weight",
                         "attn.out_proj.weight", "mlp.c_fc.weight",
                         "mlp.c_proj.bias", "ln_2.bias"))
        seeded &= torch.equal(w["frame_position_embeddings.weight"],
                              w["clip.positional_embedding"])
        print(f"  temporal tower = the text tower's first "
              f"{m.temporal_layers} blocks, frame positions = its positional "
              f"embedding: {seeded}")
        if not seeded:
            raise SystemExit("the temporal tower was not seeded from CLIP")

        # step 1 again through the plain versions from the same state, with
        # the kernel run's cluster ids and neighbour masks (as phase 8)
        model = state.model
        model.load_state_dict(first["weights"])
        st = TS.create_train_state(model, MB.MemoryBank(*first["bank"]))
        a = list(first["args"])
        a[2] = (LOOP.step_generator(cfg.train.seed, 0, "cuda")
                if cfg.model.cluster_noise else None)
        a[3] = False
        with decisions([], first["decisions"]):
            _, met = TS.train_step(st, first["batch"], *a)
        failed = []
        for n in LOSS_TERMS + ("grad_norm",):
            got, ref = k["metrics"][0][n], met[n].item()
            tol = TRAIN_GRAD_NORM_RTOL[0] if n == "grad_norm" \
                else TRAIN_LOSS_RTOL
            rel = abs(got - ref) / max(abs(ref), 1e-6)
            ok = np.isfinite(ref) and rel <= tol
            print(f"  step 1 {n}: kernels {got:.6f} plain {ref:.6f} rel "
                  f"{rel:.3g} (tolerance {tol:g}) {'ok' if ok else 'FAILED'}")
            if not ok:
                failed.append(n)
        if failed:
            raise SystemExit("step 1 through the kernels disagrees with the "
                             "plain versions: " + ", ".join(failed))
        del state, st, model, first, w, k["first"]
        torch.cuda.empty_cache()

        # the same epoch decoding the clips instead of reading the packs
        d = {}
        train(os.path.join(root, "decoded"), d, False)
        for tag, rec in (("packed", k), ("decoding", d)):
            print(f"  {tag}: steps "
                  f"{' / '.join(f'{t:.1f}' for t in rec['ms'])} ms (median "
                  f"{statistics.median(rec['ms']):.1f}), loader wait before "
                  f"each step {' / '.join(f'{t:.3f}' for t in rec['waits'])} "
                  f"s (sum {sum(rec['waits']):.3f}), run {rec['s']:.1f} s on "
                  f"{card}")

        # 5. eval from best.npz (the epoch's weights: state_epoch0.npz where
        # the eval found no hit), then from the best.pth exported from it
        npz = os.path.join(run_dir, "best.npz" if has_best
                           else "state_epoch0.npz")
        pth = os.path.join(root, "best.pth")
        flags = ["--max_words", "24", "--device", "cuda"]
        common = flags + ["--max_frames", "12"]
        eval_argv = (["--datatype", "msrvtt", *data, "--packed_dir", packed,
                      "--batch_size_val", str(REAL_TEST), "--workers", "8"]
                     + common)
        t0 = time.perf_counter()
        from_npz = cli_eval.main(eval_argv + ["--checkpoint", npz])
        t_eval = time.perf_counter() - t0
        with contextlib.redirect_stdout(io.StringIO()):
            cli_export.main(["--checkpoint", npz, "--out", pth] + common)
        from_pth = cli_eval.main(eval_argv + ["--checkpoint", pth])
        same = all({n: float(v) for n, v in a_.items()}
                   == {n: float(v) for n, v in b_.items()}
                   for a_, b_ in zip(from_npz, from_pth))
        print(f"  cli.eval from {os.path.basename(npz)}: t2v R@1 "
              f"{from_npz[0]['R1']:.2f}, v2t R@1 {from_npz[1]['R1']:.2f} "
              f"({t_eval:.1f} s); from best.pth (cli.export_checkpoint): "
              f"R@K equal {same}")
        if not same:
            raise SystemExit("R@K from best.pth differs from best.npz")

        # 6. the index of the test split and one query
        idx = os.path.join(root, "index.npz")

        def index_then_search():
            got = []
            _, c = counted(lambda: cli_index.main(
                ["--datatype", "msrvtt", *data,
                 "--checkpoint", npz, "--out", idx, "--batch_size",
                 str(REAL_TEST), "--workers", "8"] + common))
            got.append(c)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, c = counted(lambda: cli_search.main(
                    ["--index", idx, "--checkpoint", npz, "--query",
                     REAL_QUERY, "--topk", "5"] + flags))
            got.append(c)
            return buf.getvalue(), got

        hits, (c_index, c_search) = index_then_search()
        small = m.clip.vision_layers + m.temporal_layers
        want_i = dict.fromkeys(kernel_wrappers(), 0)
        want_i["K1"] = small
        want_s = dict.fromkeys(kernel_wrappers(), 0)
        want_s.update({"K1": m.clip.transformer_layers, "K2": 1})
        print(f"  cli.index ({REAL_TEST} test videos, one batch): {c_index} "
              f"(expected K1 = {small}); cli.search: {c_search} (expected "
              f"K1 = {m.clip.transformer_layers}, K2 = 1)")
        if c_index != want_i or c_search != want_s:
            raise SystemExit("launch counts do not match cli.index / "
                             "cli.search")
        paths["real_inputs_index_search"] = {
            n: c_index[n] + c_search[n] for n in c_index}
        scores = [float(ln.rsplit("(", 1)[1].rstrip(")"))
                  for ln in hits.splitlines() if ln.strip()[:1].isdigit()]
        print("  " + hits.strip().replace("\n", "\n  "))
        if len(scores) != 5 or not all(np.isfinite(scores)):
            raise SystemExit("cli.search did not print 5 finite hits")
        with np.load(idx) as f:
            v = f["v_feat"].astype(np.float32)
            ids = sorted(map(str, f["video_ids"]))
        if v.shape != (REAL_TEST, 12, m.clip.embed_dim) or \
                not np.isfinite(v).all() or ids != sorted(
                    f"video{i}" for i in range(REAL_TRAIN, n_videos)):
            raise SystemExit("the index does not hold the test split")

        print(f"  pack_dataset {pack_ms:.2f} ms/clip of wall time over 8 "
              f"decode threads ({8 * pack_ms:.1f} thread-ms/clip); "
              f"loader wait packed {sum(k['waits']):.3f} s vs decoding "
              f"{sum(d['waits']):.3f} s per epoch; median step "
              f"{statistics.median(k['ms']):.1f} ms (packed) / "
              f"{statistics.median(d['ms']):.1f} ms (decoding) from the .pt "
              f"start on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 19: the model-sharded strategies over torch.distributed
# ---------------------------------------------------------------------------

# ViT-B/32 at full width and depth (bf16) at the MSR-VTT recipe's widths
# (24 words x 12 frames); only the data is cut: global batch 32, a bank of
# 2 x 32, 2 steps a strategy.  Each strategy runs as gloo ranks on the one
# card (NCCL refuses two ranks on one device), held to one process over the
# same global batches with its DPC-KNN clusters and top-k masks replayed.
SH_B, SH_FILL, SH_STEPS, SH_M = 32, 2, 2, 4
SH_TIMEOUT = 600
SH_EVAL_N = 16
# (b) FSDP and (c) the pipeline compute what one process computes, in
# another order: phase 17's bars (DP_*).  (a) tensor parallelism and (d)
# pipeline x tensor round each rank's partial sums to bf16 (K10's output,
# the MLP's row-parallel product) before their fp32 sum, where one process
# rounds the attention sublayer's whole sum once (K1).  With random weights
# a sublayer's output is as large as the residual stream, so that is ~2^-9
# of the stream a block, and a leaf whose gradient is a small difference
# (the token-weight nets' first layer, through the softmax over tokens)
# moves by tens of percent while the rest move by a few.  One scalar bar a
# kind cannot sit between that and a fault, so each quantity is held to
# its own floor: a witness, one process on the fused route (K8/K9) against
# one process on the block route (K1/K3), the same computation rounded at
# other points, from the same start with the same decisions; each
# quantity's bar is FLOOR_FOLD x the witness's reading for it, never below
# the bars below (loss terms 5e-3 and norms 2e-2 as stated before the
# first run; moments, updates and the bank phase 17's), a loss term's never
# above phase 8's 1e-2.  A planted fault, one process with the gradient of
# one TP-split leaf halved (SH_FAULT_LEAF), must fail at these bars.
TP_LOSS_RTOL = 5e-3
TP_GRAD_NORM_RTOL = 2e-2
SH_FAULT_LEAF = "clip.visual.transformer.resblocks.5.mlp.c_fc.weight"
# (e) the eval's [16, 16] similarity under tensor parallelism against one
# process, in standard deviations of the one-process matrix: at most
# FLOOR_FOLD x the witness's (one process's eval on the fused route
# against the block route)
SH_STRATEGIES = {     # world → [(name, mesh shape, axes, fsdp, pipeline)]
    2: [("tp", (1, 2), ("data", "model"), False, False),
        ("fsdp", (2,), ("data",), True, False),
        ("pipeline", (1, 2), ("data", "stage"), False, True)],
    4: [("pipeline_tensor", (1, 2, 2), ("data", "stage", "model"), False,
         True)],
}


def sharded_config(fsdp=False, pipeline=False, fused=False):
    import dataclasses as dc

    from neighborretr_tpu_torch.core.config import Config
    cfg = Config()
    return dc.replace(
        cfg, model=dc.replace(cfg.model, attention_impl="fused" if fused
                              else "fused_block"),
        train=dc.replace(cfg.train, batch_size=SH_B, mb_batch=SH_FILL,
                         fsdp=fsdp,
                         pipeline_parallel=2 if pipeline else 1,
                         pipeline_microbatches=SH_M))


def sharded_run(cfg, mesh=None, replay=None, n_steps: int = SH_STEPS,
                seed0: int = 300, halve=None):
    """Bank fill (SH_FILL batches) and n_steps steps from init_model(seed=0)
    placed on `mesh` (one process when None), on this rank's block of each
    global batch; `halve`: a parameter whose gradient is halved (a planted
    fault) → record: per step the metrics, ms and decisions; launch
    counts; after the last step the full parameters, the compared moments
    and the bank on the host (a collective: every rank gathers) and a hash
    of the replicated parameters; this rank's parameter + moment bytes and
    peak memory."""
    import hashlib

    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS

    m = cfg.model
    torch.cuda.reset_peak_memory_stats()
    model = init_model(m, seed=0, device="cuda")
    if mesh is not None:
        pmesh.place_params(model, mesh, fsdp=cfg.train.fsdp)

    def block(b):
        return pmesh.batch_block(b, mesh) if mesh is not None else b

    rec = dict(metrics=[], ms=[], decisions=[])

    def run():
        bank = MB.create(cfg.train.memory_bank_capacity, m.max_words,
                         m.max_frames, m.width, device="cuda")
        for i in range(SH_FILL):
            bank = TS.fill_bank_step(model, bank, block(device_batch(
                m, SH_B, seed0 + i)), cfg, i * SH_B, mesh=mesh)
        state = TS.create_train_state(model, bank)
        if halve is not None:            # trainable from here on
            model.get_parameter(halve).register_hook(lambda g: 0.5 * g)
        for i in range(n_steps):
            batch = block(device_batch(m, SH_B, seed0 + SH_FILL + i))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda").manual_seed(1000 + i)
            log = []
            with decisions(log, replay[i] if replay else None):
                state, met = TS.train_step(state, batch, cfg, 30, gen,
                                           mesh=mesh)
            torch.cuda.synchronize()
            rec["ms"].append(1e3 * (time.perf_counter() - t0))
            rec["decisions"].append(log)
            rec["metrics"].append({k: v.item() for k, v in met.items()})
        return state

    state, rec["counts"] = counted(run)
    rec["bytes"] = sum(
        t.numel() * t.element_size() for t in
        [pmesh.local(p) for p in model.parameters()]
        + list(state.opt.m.values()) + list(state.opt.v.values()))
    params = pmesh.full_state_dict(model)
    pl = pmesh.placement_of(model)
    mom = pmesh.gather_full(state.opt.m, pl) if pl is not None else state.opt.m

    def replicated(n):
        p = pl.params[n] if pl is not None else None
        return p is None or not (p.tp or p.fsdp or p.stage is not None)

    rec.update(
        params={n: t.float().cpu() for n, t in params.items()},
        moments={n: mom[n].float().cpu() for n in TRAIN_COMPARED},
        bank=[t.cpu() for t in state.bank],
        replicated_hash=hashlib.sha256(b"".join(
            pmesh.local(p).detach().float().cpu().numpy().tobytes()
            for n, p in model.named_parameters()
            if replicated(n))).hexdigest(),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, state, params, mom
    torch.cuda.empty_cache()
    return rec


def sharded_rank_worker(world: int, rank: int, port: int, work: str
                        ) -> None:
    """One rank of phase 19: gloo over localhost with the tensors on the
    card, its world's strategies in turn, then (two ranks) the eval CLI's
    run under --tensor_parallel 2 in the same group (NCCL, the CLI's own
    backend on the card, refuses two ranks on one card); results to
    work/w{world}rank{r}.pt."""
    import torch.distributed as dist

    from neighborretr_tpu_torch.ops import _build
    from neighborretr_tpu_torch.parallel import mesh as pmesh
    _build.load(*LIBS)                 # built by the parent: loads only
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    plan = torch.load(os.path.join(work, "plan.pt"), map_location="cuda:0",
                      weights_only=False)
    out = {}
    runs = [(name, sharded_config(fsdp, pipeline), pmesh.make_mesh(
        "cuda:0", shape, axes), SH_STEPS)
        for name, shape, axes, fsdp, pipeline in SH_STRATEGIES[world]]
    if world == 2:              # (a) on the fused route
        runs.append(("tp_fused", sharded_config(fused=True),
                     pmesh.make_mesh("cuda:0", (1, 2), ("data", "model")),
                     SH_STEPS))
    for name, cfg, mesh, n_steps in runs:
        rec = sharded_run(cfg, mesh, plan, n_steps)
        rec.pop("decisions")
        if rank:
            rec.pop("params")
            rec.pop("moments")
        out[name] = rec
    if world == 2:
        out["tp_eval"] = sharded_eval(["--tensor_parallel", "2"],
                                      rank=rank, world=world)
    dist.destroy_process_group()
    torch.save(out, os.path.join(work, f"w{world}rank{rank}.pt"))


def sharded_eval(extra, rank=None, world=None):
    """cli.eval at ViT-B/32 width on SH_EVAL_N synthetic videos, seeded
    random weights → (R@K, the similarity matrix on the host, launches).
    With `rank`: the CLI's run as that rank of the started `world`-rank
    process group."""
    from neighborretr_tpu_torch.cli import eval as cli_eval
    from neighborretr_tpu_torch.cli.common import setup_logger
    from neighborretr_tpu_torch.train import evaluate as EV
    sims = []
    real = EV.similarity_matrix_device

    def keep(*a, **kw):
        s = real(*a, **kw)
        sims.append(s.float().cpu())
        return s

    argv = ["--datatype", "synthetic", "--clip_checkpoint", "random",
            "--synthetic_size", str(SH_EVAL_N), "--batch_size_val",
            str(SH_EVAL_N), "--max_frames", "12", "--workers", "0", *extra]
    EV.similarity_matrix_device = keep

    def drive():
        if rank is None:
            return cli_eval.main(argv)
        args = cli_eval.parse_args(argv)
        args.num_processes, args.process_id = world, rank
        return cli_eval.run(args, setup_logger())

    try:
        (t2v, v2t), counts = counted(drive)
    finally:
        EV.similarity_matrix_device = real
    return dict(t2v=t2v, v2t=v2t, sim=sims[-1], counts=counts)


TP_BARS = (TP_LOSS_RTOL, TP_GRAD_NORM_RTOL, DP_MOMENT_REL_L2,
           DP_UPDATE_REL_L2, DP_BANK_REL_L2)


def phase_sharded(card: str):
    """(a) tensor parallelism, data 1 x model 2, on the block and on the
    fused route; (b) FSDP2 over 2 ranks; (c) the pipeline, stage 2 x M 4;
    (d) pipeline x tensor, 1 x 2 x 2 (four processes); (e) cli.eval
    --tensor_parallel 2 on 16 videos; each against one process, (a), (d)
    and (e) at bars from a witness that a planted fault must fail → launch
    counts by path, summed over the ranks."""
    print("== phase 19: model-sharded strategies (torch.distributed over "
          "gloo, ranks sharing one card; ViT-B/32 width, bf16, depth not "
          "cut, 24 words x 12 frames, global batch 32, bank 2 x 32)")
    import shutil
    import socket
    import tempfile

    from neighborretr_tpu_torch.models.weights_io import init_model
    t_phase = time.perf_counter()
    cfg = sharded_config()
    m = cfg.model
    layers = (m.clip.vision_layers + m.clip.transformer_layers
              + m.temporal_layers)
    start = {n: p.detach().cpu() for n, p in init_model(
        m, 0, "cuda").named_parameters()}
    torch.cuda.empty_cache()
    ref = {"block": sharded_run(cfg)}
    plan = ref["block"]["decisions"]
    ref["fused"] = sharded_run(sharded_config(fused=True), replay=plan)
    one_bytes, one_peak = ref["block"]["bytes"], ref["block"]["peak_gib"]
    for route, r in ref.items():
        print(f"  one process, {route} route: steps "
              f"{' / '.join(f'{t:.1f}' for t in r['ms'])} ms, peak "
              f"{r['peak_gib']:.2f} GiB, parameters + moments "
              f"{r['bytes'] / 2 ** 30:.3f} GiB, launches {r['counts']}")
    # the witness: the same computation rounded at other points
    floor = held_readings(ref["fused"], ref["block"], start)
    for kind in ("loss", "grad_norm", "moment", "update", "bank"):
        q = max((q for q in floor[0] if q[0] == kind), key=floor[0].get)
        print(f"  witness, one process's fused route against its block "
              f"route: {kind} at most {floor[0][q]:.3g} ({q[1]})")
    fault = sharded_run(cfg, replay=plan, halve=SH_FAULT_LEAF)
    fault_r = held_readings(fault, ref["block"], start)[0]
    try:
        dp_held("planted fault", fault, ref["block"], start, TP_BARS, 19,
                floor, verbose=False)
        caught = None
    except SystemExit as e:
        caught = str(e)[:300]
    q = ("moment", SH_FAULT_LEAF)
    print(f"  planted fault, the gradient of {SH_FAULT_LEAF} halved in one "
          f"process: its moment {fault_r[q]:.3g} rel L2 (witness "
          f"{floor[0][q]:.3g}); at the TP bars "
          f"{'caught: ' + caught if caught else 'NOT caught'}")
    del fault
    one_eval = sharded_eval(["--device", "cuda"])
    eval_floor = sharded_eval(["--device", "cuda", "--attention_impl",
                               "fused"])["sim"]

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    work = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    ranks = {}
    try:
        torch.save(plan, os.path.join(work, "plan.pt"))
        for world in (2, 4):
            port = free_port()
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sharded-rank",
                 str(world), str(r), str(port), work],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(world)]
            try:
                logs = []
                for p in procs:
                    try:
                        logs.append(p.communicate(timeout=SH_TIMEOUT)[0])
                    except subprocess.TimeoutExpired:
                        raise SystemExit(f"phase 19: a rank of {world} did "
                                         f"not finish in {SH_TIMEOUT} s")
                for r, (p, log) in enumerate(zip(procs, logs)):
                    if p.returncode != 0:
                        raise SystemExit(f"phase 19: rank {r} of {world} "
                                         f"failed:\n{log[-4000:]}")
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            print(f"  {world} ranks (processes on {card}, gloo with the "
                  f"tensors on the card) ran "
                  f"{', '.join(s[0] for s in SH_STRATEGIES[world])}"
                  f"{', the fused step and the eval' if world == 2 else ''} "
                  f"in {time.perf_counter() - t0:.1f} s, processes included")
            ranks[world] = [torch.load(os.path.join(
                work, f"w{world}rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    zero = dict.fromkeys(kernel_wrappers(), 0)
    per_stage = layers // 2      # every tower's depth divides by 2 stages
    want = {
        "tp": dict(zero, K10=(SH_FILL + SH_STEPS) * layers,
                   K11=SH_STEPS * layers, K4=2 * SH_STEPS, K5=2 * SH_STEPS),
        "tp_fused": dict(zero, K8=(SH_FILL + SH_STEPS) * layers,
                         K9=SH_STEPS * layers, K4=2 * SH_STEPS,
                         K5=2 * SH_STEPS),
        "fsdp": dict(zero, K1=(SH_FILL + SH_STEPS) * layers,
                     K3=SH_STEPS * layers, K4=2 * SH_STEPS,
                     K5=2 * SH_STEPS),
        "pipeline": dict(zero, K1=(SH_FILL + SH_M * SH_STEPS) * per_stage,
                         K3=SH_M * SH_STEPS * per_stage, K4=2 * SH_STEPS,
                         K5=2 * SH_STEPS),
        "pipeline_tensor": dict(
            zero, K10=(SH_FILL + SH_M * SH_STEPS) * per_stage,
            K11=SH_M * SH_STEPS * per_stage, K4=2 * SH_STEPS,
            K5=2 * SH_STEPS)}
    paths = {}
    failed = [] if caught else [
        f"phase 19: the TP bars do not catch a halved gradient of "
        f"{SH_FAULT_LEAF}"]

    def held_or_note(label, got, want, bars, floor=None):
        """dp_held at `bars` (and `floor`); a failure is noted, and fails
        the phase once every strategy has been read."""
        try:
            dp_held(label, got, want, start, bars, phase=19, floor=floor)
        except SystemExit as e:
            failed.append(str(e))

    labels = {"tp": "(a) tensor parallel, block route",
              "tp_fused": "(a) tensor parallel, fused route",
              "fsdp": "(b) FSDP2", "pipeline": "(c) pipeline",
              "pipeline_tensor": "(d) pipeline x tensor"}
    for world, strategies in SH_STRATEGIES.items():
        for name in [s[0] for s in strategies] + (
                ["tp_fused"] if world == 2 else []):
            recs = [r[name] for r in ranks[world]]
            label = labels[name]
            r0 = recs[0]
            counts = [r["counts"] for r in recs]
            print(f"  {label}: launches per rank {counts} (expected "
                  f"{want[name]} each); steps "
                  f"{' / '.join(f'{t:.1f}' for t in r0['ms'])} ms"
                  f" on rank 0 of {world} ranks sharing one card (not a "
                  f"scale-out number); peak "
                  f"{max(r['peak_gib'] for r in recs):.2f} GiB a rank "
                  f"against {one_peak:.2f} in one process; parameters + "
                  f"moments {r0['bytes'] / 2 ** 30:.3f} GiB on rank 0 = "
                  f"{r0['bytes'] / one_bytes:.3f} x one process's")
            if any(c != want[name] for c in counts):
                failed.append(f"phase 19 {label}: launch counts")
            if name == "fsdp" and max(r["bytes"] for r in recs) > \
                    0.55 * one_bytes:
                failed.append("phase 19 (b): FSDP's parameter + moment "
                              "bytes a rank above 0.55 x one process's")
            same = len({r["replicated_hash"] for r in recs}) == 1
            gap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                      for r in recs[1:]
                      for a, b in zip(r["metrics"], r0["metrics"]) for k in a)
            print(f"  {label}: replicated parameters bit-equal across the "
                  f"ranks: {same}; the ranks' metrics differ by at most "
                  f"{gap:.3g} relative")
            if not same:
                failed.append(f"phase 19 {label}: the ranks' replicated "
                              "parameters differ")
            if name in ("tp", "tp_fused", "pipeline_tensor"):
                held_or_note(label, r0, ref["fused" if name == "tp_fused"
                                             else "block"], TP_BARS, floor)
            else:
                held_or_note(label, r0, ref["block"], DP_BARS)
            paths[f"sharded_{name}"] = {
                k: sum(c[k] for c in counts) for k in zero}
    # (e)
    ev = [r["tp_eval"] for r in ranks[2]]
    want_eval = dict(zero, K10=layers, K2=1)
    one_sim = one_eval["sim"]
    sd = one_sim.std().item()
    wit = (eval_floor - one_sim).abs().max().item() / sd
    gap = max((e["sim"] - one_sim).abs().max().item() for e in ev)
    print(f"  (e) cli.eval --tensor_parallel 2 on {SH_EVAL_N} videos: "
          f"launches per rank {[e['counts'] for e in ev]} (expected "
          f"{want_eval} each: the text and video batches through K10, K2 "
          f"once); similarity within {gap / sd:.3g} standard deviations of "
          f"one process's matrix (tolerance {FLOOR_FOLD * wit:.3g}, "
          f"witness {wit:.3g}: its eval on the fused route), "
          f"{gap / one_sim.abs().max().item():.3g} of its largest "
          f"magnitude; t2v R@1 {ev[0]['t2v']['R1']:.2f} / one process "
          f"{one_eval['t2v']['R1']:.2f}, v2t R@1 {ev[0]['v2t']['R1']:.2f} / "
          f"{one_eval['v2t']['R1']:.2f}")
    if any(e["counts"] != want_eval for e in ev) or \
            gap / sd > FLOOR_FOLD * wit:
        failed.append("phase 19 (e): the eval under tensor parallelism")
    paths["sharded_tp_eval"] = {k: sum(e["counts"][k] for e in ev)
                                for k in zero}
    print(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit("\n".join(failed))
    return paths


# ---------------------------------------------------------------------------
# phase 20: the trainer's host-memory paths
# ---------------------------------------------------------------------------

# the train CLI at the MSR-VTT recipe, its batches through the prefetch
HOST_ARGV = [
    "--datatype", "synthetic", "--clip_checkpoint", "random",
    "--max_words", "24", "--max_frames", "12", "--batch_size", "128",
    "--mb_batch", "15", "--epochs", "1", "--synthetic_size", "640",
    "--batch_size_val", "128", "--n_display", "1", "--mid_epoch_eval", "0",
    "--workers", "8", "--seed", "42"]
# what the prefetch is read against, measured on an NVIDIA H100 80GB HBM3
# at 700 W before the loop had it: phase 8's step and the train CLI's under
# the device augment, phase 10's loader wait before the logged steps
EARLIER_STEP_MS, EARLIER_CLI_MS = 282.6, 299.1
EARLIER_LONG_WAITS = (2.738, 2.889)
# (bank, moments) placements of phase 20 (b), device/device the reference
HOST_PLACEMENTS = (("device", "device"), ("device", "host"),
                   ("host", "device"), ("host", "host"))
NAN_LEAF = "clip.visual.transformer.resblocks.5.mlp.c_fc.weight"


@contextlib.contextmanager
def deterministic():
    """torch's ordered forms of its scatter-adds (embedding backward,
    `index_add_`: float atomics otherwise, 0.4% of a gradient between two
    runs of one step), so that two placements can be held to the bit;
    prints the ops torch has no ordered form of, if any ran."""
    import warnings
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    notes = sorted({str(w.message).splitlines()[0] for w in caught
                    if "determinis" in str(w.message)})
    for note in notes:
        print(f"  (deterministic mode) {note}")


def _host_batch(m, B: int, seed: int, frames=None):
    """One synthetic host batch (numpy) at the model's widths: captions of
    4..W words ending in EoT, uint8 frames drawn as uint8."""
    rng = np.random.default_rng(seed)
    W, R, V = m.max_words, m.clip.image_resolution, m.clip.vocab_size
    F = frames or m.max_frames
    n = rng.integers(4, W + 1, size=B)
    mask = (np.arange(W)[None] < n[:, None]).astype(np.float32)
    ids = rng.integers(1, V - 1, size=(B, W)).astype(np.int32)
    ids[np.arange(B), n - 1] = V - 1
    ids[mask == 0] = 0
    return {"text_ids": ids, "text_mask": mask,
            "video": rng.integers(0, 256, (B, F, R, R, 3), dtype=np.uint8),
            "video_mask": np.ones((B, F), np.float32),
            "idx": np.arange(B, dtype=np.int32) + B * seed}


def h2d_times(batch, reps: int = 3) -> dict:
    """One host batch to the card, median of `reps`: `to_device` from
    pageable memory (host clock, synchronised: the host blocks for it), and
    the prefetch's two halves, the copy into its pinned slot (host clock,
    on the prefetch's thread) and the upload on the copy stream (CUDA
    events on that stream)."""
    from neighborretr_tpu_torch.data import device_prefetch as DP
    from neighborretr_tpu_torch.train import step as TS
    from neighborretr_tpu_torch.utils import host_memory

    nb = sum(np.asarray(batch[k]).nbytes for k in DP.BATCH_KEYS)
    pageable, pin, upload = [], [], []
    stream = host_memory.copy_stream("cuda", "batches")
    slot = DP._Slot()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = TS.to_device(batch, "cuda")
        torch.cuda.synchronize()
        pageable.append(1e3 * (time.perf_counter() - t0))
        del dev
        t0 = time.perf_counter()
        slot.fill(batch)
        pin.append(1e3 * (time.perf_counter() - t0))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            a.record(stream)
            dev = {k: v.to("cuda", non_blocking=True)
                   for k, v in slot.host.items()}
            b.record(stream)
        slot.uploaded = b
        b.synchronize()
        upload.append(a.elapsed_time(b))
        del dev
    med = statistics.median
    return {"bytes": nb, "pageable_ms": med(pageable), "pin_ms": med(pin),
            "upload_ms": med(upload)}


def h2d_line(h: dict) -> str:
    def rate(ms):
        return h["bytes"] / ms / 1e6
    return (f"to_device from pageable memory {h['pageable_ms']:.3f} ms "
            f"({rate(h['pageable_ms']):.2f} GB/s, the host blocked); the "
            f"prefetch: pinned slot filled in {h['pin_ms']:.3f} ms on its "
            f"thread, uploaded on the copy stream in {h['upload_ms']:.3f} ms "
            f"({rate(h['upload_ms']):.2f} GB/s)")


def phase_host_memory(card: str, block_ms=None):
    """The trainer's host-memory paths at the MSR-VTT recipe: (a) one
    batch's upload, pageable against the prefetch's; (b) the four
    placements of the bank and the moments from equal state, bit-equal;
    (c) the train CLI through the prefetch against the synchronous copy;
    (d) --debug_nans on a planted NaN; (e) the learning check with all
    three on → launch counts by path.  block_ms: phase 8's ms/step in this
    run (None when phase 8 did not run)."""
    print("== phase 20: host memory (ViT-B/32 width, bf16, the MSR-VTT "
          "recipe: batch 128, bank 15 x 128; the prefetch, host moments and "
          "bank, --debug_nans)")
    import dataclasses as dc
    import shutil
    import tempfile

    from neighborretr_tpu_torch.cli import train as cli
    from neighborretr_tpu_torch.core.config import Config
    from neighborretr_tpu_torch.models.weights_io import init_model
    from neighborretr_tpu_torch.tools import learning_check
    from neighborretr_tpu_torch.train import loop as LOOP
    from neighborretr_tpu_torch.train import memory_bank as MB
    from neighborretr_tpu_torch.train import step as TS
    from neighborretr_tpu_torch.utils import host_memory

    t_phase = time.perf_counter()
    paths = {}
    cfg0 = Config()      # the reference's MSR-VTT recipe: batch 128, 15 x 128
    m, B = cfg0.model, cfg0.train.batch_size
    n_fill, n_steps, t_total = cfg0.train.mb_batch, 3, 30
    cap = cfg0.train.memory_bank_capacity
    layers = (m.clip.vision_layers + m.clip.transformer_layers
              + m.temporal_layers)

    # (a)
    host = [_host_batch(m, B, seed) for seed in range(7)]
    h = h2d_times(host[0])
    print(f"  (a) one flagship batch, {h['bytes'] / 1e6:.1f} MB: "
          f"{h2d_line(h)} on {card}")

    # (b)
    batches = [TS.to_device(b, "cuda") for b in host]
    fill, steps = batches[:4], batches[4:]
    model = init_model(m, seed=0, device="cuda")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    want = dict.fromkeys(kernel_wrappers(), 0)
    want.update({"K1": (n_fill + n_steps) * layers, "K3": n_steps * layers,
                 "K4": 2 * n_steps, "K5": 2 * n_steps})

    def run(bank_at, moments_at, replay):
        cfg = dc.replace(
            cfg0, optim=dc.replace(cfg0.optim, moments_placement=moments_at),
            train=dc.replace(cfg0.train, bank_placement=bank_at))
        model.load_state_dict(start)
        out = {"ms": [], "losses": [], "decisions": []}
        with deterministic():
            bank = MB.place_bank(MB.create(cap, m.max_words, m.max_frames,
                                           m.width, device="cuda"),
                                 bank_at, "cuda")
            for i in range(n_fill):
                bank = TS.fill_bank_step(model, bank, fill[i % len(fill)],
                                         cfg, i * B)
            state = TS.create_train_state(model, bank,
                                          moments_placement=moments_at)
            gen = torch.Generator(device="cuda").manual_seed(1)
            for i, batch in enumerate(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                log = []
                with decisions(log, replay[i] if replay else None):
                    state, met = TS.train_step(state, batch, cfg, t_total,
                                               gen)
                torch.cuda.synchronize()
                out["ms"].append(1e3 * (time.perf_counter() - t0))
                out["decisions"].append(log)
                out["losses"].append([met[k].item() for k in
                                      LOSS_TERMS + ("grad_norm",)])
        host_memory.wait_copies()
        homes = {"moments": {t.is_pinned() for t in state.opt.m.values()},
                 "bank": {t.is_pinned() for t in state.bank}}
        for what, at in (("moments", moments_at), ("bank", bank_at)):
            if homes[what] != {at == "host"}:
                raise SystemExit(f"the {what} are not all in {at} memory")
        out["params"] = {k: v.cpu() for k, v in model.state_dict().items()}
        out["m"] = {n: t.cpu() for n, t in state.opt.m.items()}
        out["v"] = {n: t.cpu() for n, t in state.opt.v.items()}
        out["bank"] = [t.cpu() for t in state.bank]
        return out

    print(f"  (b) bank fill ({n_fill} batches) and {n_steps} steps from the "
          "same weights and batches under each placement, torch's "
          "deterministic algorithms on (slower steps than phase 8's), after "
          "a warm-up run of device/device whose DPC-KNN clusters and top-k "
          "masks every placement replays:")
    replay = run("device", "device", None)["decisions"]
    ref, failed, rows = None, [], []
    for bank_at, moments_at in HOST_PLACEMENTS:
        name = f"bank {bank_at}, moments {moments_at}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got, counts = counted(lambda: run(bank_at, moments_at, replay))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        paths[f"placements_bank_{bank_at}_moments_{moments_at}"] = counts
        if counts != want:
            raise SystemExit(f"{name}: launches {counts}, expected {want}")
        if ref is None:
            ref = got
            same = "the reference"
        else:
            diff = [f"loss terms of step {i + 1}" for i, (a, b) in enumerate(
                zip(got["losses"], ref["losses"])) if a != b]
            for part in ("params", "m", "v"):
                diff += [f"{part} {k}" for k, t in ref[part].items()
                         if not torch.equal(got[part][k], t)]
            diff += [f"bank.{f}" for f, a, b in zip(
                MB.MemoryBank._fields, got["bank"], ref["bank"])
                if not torch.equal(a, b)]
            same = ("loss terms, parameters, moments and bank bit-equal to "
                    "device/device" if not diff else
                    f"{len(diff)} DIFFER from device/device: "
                    + ", ".join(diff[:6]))
            if diff:
                failed.append(name)
        ms = statistics.median(got["ms"])
        rows.append((name, ms, peak))
        print(f"    {name}: steps {' / '.join(f'{t:.1f}' for t in got['ms'])}"
              f" ms (median {ms:.1f}), peak device memory {peak:.2f} GiB, "
              f"launches K1 {counts['K1']} K3 {counts['K3']} K4 "
              f"{counts['K4']} K5 {counts['K5']} (as expected); {same}")
        del got
    for i, losses in enumerate(ref["losses"]):
        print(f"    step {i + 1}: " + " ".join(
            f"{n} {v:.6f}" for n, v in zip(LOSS_TERMS + ("grad_norm",),
                                           losses)))
        if not all(np.isfinite(losses)):
            raise SystemExit(f"non-finite loss term at step {i + 1}")
    base_ms, base_peak = rows[0][1], rows[0][2]
    print("    against device/device: " + "; ".join(
        f"{n}: {ms - base_ms:+.1f} ms/step, {peak - base_peak:+.3f} GiB peak"
        for n, ms, peak in rows[1:]) + f" on {card}")
    if failed:
        raise SystemExit("host placements differ from the device placement: "
                         + ", ".join(failed))
    del ref, batches, fill, steps, start
    model.cpu()
    del model
    torch.cuda.empty_cache()

    # (c)
    argv = HOST_ARGV
    args = cli.parse_args(argv)
    n_cli = args.synthetic_size // args.batch_size
    print(f"  (c) {' '.join(argv)}, through the prefetch, then with every "
          "batch moved by to_device when the loop wants it (the loop before "
          "the prefetch), then through the prefetch again:")
    real_step, real_prefetch = LOOP.train_step, LOOP.prefetch_to_device

    def synchronous(iterator, size=2, device=None, mesh=None):
        return (TS.to_device(b, device) for b in iterator)

    def cli_run(prefetch: bool):
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_prefetch_")
        rec = {"ms": [], "starts": []}

        def timed_step(*a, **kw):
            rec["starts"].append(time.perf_counter())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_step(*a, **kw)
            torch.cuda.synchronize()
            rec["ms"].append(1e3 * (time.perf_counter() - t0))
            return out

        LOOP.train_step = timed_step
        if not prefetch:
            LOOP.prefetch_to_device = synchronous
        try:
            (state, _), counts = counted(
                lambda: cli.main(argv + ["--output_dir", out_dir]))
            with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                rows_ = list(map(json.loads, f))
            has_best = os.path.exists(os.path.join(out_dir, "best.npz"))
        finally:
            LOOP.train_step, LOOP.prefetch_to_device = real_step, real_prefetch
            shutil.rmtree(out_dir, ignore_errors=True)
        ev = [r for r in rows_ if r["kind"] == "eval"]
        train_rows = [r for r in rows_ if r["kind"] == "train"]
        if len(ev) != 1 or state.step != n_cli or len(train_rows) != n_cli:
            raise SystemExit("the train CLI did not take its steps and eval")
        n_evals = 1 + has_best
        want = dict.fromkeys(kernel_wrappers(), 0)
        want.update({"K1": (2 * n_cli + n_evals) * layers,
                     "K3": n_cli * layers, "K4": 2 * n_cli, "K5": 2 * n_cli,
                     "K2": n_evals})
        if counts != want:
            raise SystemExit(f"launches {counts}, expected {want}")
        if not all(np.isfinite(r["loss"]) for r in train_rows):
            raise SystemExit("non-finite loss in the train CLI")
        rec["waits"] = [r["data_wait_s"] for r in train_rows]
        rec["gaps"] = [1e3 * (b - a) for a, b in
                       zip(rec["starts"], rec["starts"][1:])]
        return counts, rec

    runs = []
    for label, prefetch in (("prefetch", True), ("to_device", False),
                            ("prefetch", True)):
        counts, rec = cli_run(prefetch)
        runs.append((prefetch, rec))
        if prefetch:
            paths["prefetch_trainer"] = counts
        print(f"    {label}: steps {' / '.join(f'{t:.1f}' for t in rec['ms'])}"
              f" ms (synchronised around each); step start to step start "
              f"{' / '.join(f'{t:.1f}' for t in rec['gaps'])} ms (median "
              f"after the first {statistics.median(rec['gaps'][1:]):.1f}); "
              f"data_wait_s {' / '.join(f'{w:.4f}' for w in rec['waits'])}; "
              f"launches {counts} (as expected)")

    def med(prefetch, key):
        return statistics.median([x for p, r in runs if p == prefetch
                                  for x in r[key][1:]])

    print(f"    the prefetch: {med(True, 'gaps'):.1f} ms from step to step "
          f"against {med(False, 'gaps'):.1f} with to_device "
          f"({med(True, 'gaps') - med(False, 'gaps'):+.1f} ms); steps "
          f"{med(True, 'ms'):.1f} against {med(False, 'ms'):.1f} ms (phase 8 "
          f"{'in this run ' + format(block_ms, '.1f') if block_ms else 'not run'}"
          f"; before the prefetch: phase 8's {EARLIER_STEP_MS} ms, the train "
          f"CLI's {EARLIER_CLI_MS} ms under the device augment) on {card}")

    # (d)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_debug_nans_")
    argv = HOST_ARGV + ["--output_dir", out_dir, "--debug_nans",
                        "--synthetic_size", "256"]
    rec = {"ms": []}

    def planting_step(state, *a, **kw):
        if state.step == 1:
            with torch.no_grad():
                dict(state.model.named_parameters())[NAN_LEAF].view(-1)[
                    0] = float("nan")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(state, *a, **kw)
        torch.cuda.synchronize()
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    raised = None
    LOOP.train_step = planting_step
    try:
        cli.main(argv)
    except FloatingPointError as e:
        raised = str(e)
    finally:
        LOOP.train_step = real_step
        TS.set_debug_nans(False)
        shutil.rmtree(out_dir, ignore_errors=True)
    ok = raised is not None and NAN_LEAF in raised and len(rec["ms"]) == 1
    print(f"  (d) cli.train --debug_nans, a NaN planted in {NAN_LEAF} before "
          f"step 2: {'FloatingPointError: ' + raised if raised else 'no error'}"
          f"; the clean step 1 under the flag took "
          f"{' / '.join(f'{t:.1f}' for t in rec['ms'])} ms (autograd's "
          f"anomaly mode and the finiteness checks) "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("--debug_nans did not name the planted NaN")

    # (e)
    got, counts = counted(lambda: learning_check.run("cuda", "host", "host"))
    paths["learning_check"] = counts
    ok = min(got["t2v_r1"], got["v2t_r1"]) >= learning_check.R1_BAR
    print(f"  (e) the learning check (tiny towers memorise "
          f"{learning_check.PAIRS} pairs from random init through "
          f"run_training, the prefetch, host moments and host bank on): "
          f"{got['steps']} steps, t2v R@1 {got['t2v_r1']:.2f}, v2t R@1 "
          f"{got['v2t_r1']:.2f} (bar {learning_check.R1_BAR:g}), "
          f"{got['seconds']:.1f} s; launches {counts} "
          f"{'ok' if ok else 'FAILED'}")
    if not ok or got["steps"] != learning_check.STEPS:
        raise SystemExit("the learning check did not reach its R@1")
    print(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return paths


def alone(argv):
    """`--alone 9 [--seeds S ...]`: phase 9 by itself once per generator
    seed; `--alone 16` / `17` / `18` / `19` / `20`: that phase by itself.
    Prints no JSON lines."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--alone", choices=("9", "16", "17", "18", "19", "20"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    card = phase_device()
    phase_build()
    if args.alone == "16":
        phase_serving_daemon(card)
        return
    if args.alone == "17":
        phase_data_parallel(card)
        return
    if args.alone == "18":
        phase_real_inputs(card)
        return
    if args.alone == "19":
        phase_sharded(card)
        return
    if args.alone == "20":
        phase_host_memory(card)
        return
    for seed in args.seeds:
        print(f"-- phase 9 alone, generator seed {seed}")
        phase_k6_k7(torch.Generator(device="cuda").manual_seed(seed))


def main():
    if "--dp-rank" in sys.argv[1:]:          # a rank of phase 17's (b), (c)
        i = sys.argv.index("--dp-rank")
        return dp_rank_worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                              sys.argv[i + 3])
    if "--sharded-rank" in sys.argv[1:]:     # a rank of phase 19
        i = sys.argv.index("--sharded-rank")
        return sharded_rank_worker(*map(int, sys.argv[i + 1:i + 4]),
                                   sys.argv[i + 4])
    if "--alone" in sys.argv[1:]:
        return alone(sys.argv[1:])
    profile = "--profile" in sys.argv[1:]
    card = phase_device()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    k1_rows = phase_k1(g)
    k2 = phase_k2(g)
    serving_counts, _ = phase_serving()
    k3_rows = phase_k3(g)
    k4, k5 = phase_k4_k5(g)
    train_counts, block_ms, _, train_peak = phase_train(profile, card)
    k6, k7 = phase_k6_k7(g)
    trainer_counts, _, _ = phase_trainer(profile, card)
    k8, k9 = phase_k8_k9(g)
    fused_serving_counts, _ = phase_serving("fused")
    fused_train_counts, fused_ms, _, _ = phase_train(profile, card, "fused")
    print(f"  ViT-B/32 train step, batch 128, on {card}: {fused_ms:.1f} ms on "
          f"the attention_impl='fused' route (K8/K9), {block_ms:.1f} ms on "
          "the sublayer kernels' route (K1/K3, phase 8)")
    backbone_counts, _ = phase_vit_l(card, profile)
    check_counts, k10, k11 = phase_k10_k11(g)
    augment_counts, _, _ = phase_augment(card, block_ms)
    daemon_counts = phase_serving_daemon(card)
    dp_counts = phase_data_parallel(card, block_ms, train_peak)
    real_counts = phase_real_inputs(card)
    sharded_counts = phase_sharded(card)
    host_counts = phase_host_memory(card, block_ms)

    def kernel(name, source, replaces, launches, row, timed_at, **extra):
        err, ms, plain_ms, bound_ms, bound_by, *library_ms = row
        return {"name": name, "route": "cuda",
                "source": f"neighborretr_tpu_torch/csrc/{source}",
                "replaces": f"neighborretr_tpu/ops/{replaces}",
                "launches": sum(launches.values()),
                "launches_by_path": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms[0] if library_ms else None,
                "timed_at": timed_at, **extra}

    def paths(k):     # this run's counts on the main paths
        return {"serving": serving_counts[k], "train": train_counts[k],
                "trainer": trainer_counts[k],
                "fused_serving": fused_serving_counts[k],
                "fused_train": fused_train_counts[k],
                "larger_backbones": backbone_counts[k],
                "sublayer_kernel_check": check_counts[k],
                "augment_trainer": augment_counts[k],
                "serving_daemon": daemon_counts[k],
                **{path: c[k] for path, c in dp_counts.items()},
                **{path: c[k] for path, c in real_counts.items()},
                **{path: c[k] for path, c in sharded_counts.items()},
                **{path: c[k] for path, c in host_counts.items()}}

    def by_shape(rows):
        return {str(k): list(r[1:]) for k, r in rows.items()}

    def worst(rows, first):
        return (max(r[0] for r in rows.values()),) + rows[first][1:]

    record = {"kernels": [
        kernel("ln_attention_residual", "ln_attention_residual.cu",
               "pallas_block_attention.py:500",
               paths("K1"),
               worst(k1_rows, "vision"), "vision N=768 L=50 D=768 H=12",
               ms_plain_bound_by_shape=by_shape(k1_rows)),
        kernel("interaction_similarity", "interaction_similarity.cu",
               "pallas_similarity.py:132",
               paths("K2"), worst(k2, "Q=64"),
               "Q=64 T=24 N=10000 V=12 D=512 (bound: 3xTF32)",
               bound_fp32_simt_ms=k2["Q=64"][6],
               ms_plain_bound_by_shape=by_shape(k2)),
        kernel("ln_attention_residual_bwd", "ln_attention_residual_bwd.cu",
               "pallas_block_attention.py:534",
               paths("K3"),
               worst(k3_rows, "vision"), "vision N=1536 L=50 D=768 H=12",
               ms_plain_bound_by_shape=by_shape(k3_rows)),
        kernel("interaction_mean", "interaction_similarity.cu",
               "pallas_similarity.py:455",
               paths("K4"), worst(k4, 1),
               "A=128 T=24 B=1920 V=12 D=512 axis=1 (no grad; bound: "
               "3xTF32)", bound_fp32_simt_ms=k4[1][6],
               ms_plain_bound_by_shape=by_shape(k4)),
        kernel("interaction_similarity_bwd", "interaction_similarity.cu",
               "pallas_similarity.py:336",
               paths("K5"), worst(k5, 1),
               "A=128 T=24 B=1920 V=12 D=512 (the axis=1 centrality's text "
               "side from K4's residuals, the train step's form)",
               ms_plain_bound_by_shape=by_shape(k5)),
        kernel("interaction_similarity_blocked",
               "interaction_similarity_blocked.cu",
               "pallas_similarity_blocked.py:172",
               paths("K6"), worst(k6, (128, 1920)),
               "A=128 T=64 B=1920 V=64 D=512, with the residual stores "
               "(bound: 3xTF32)", bound_fp32_simt_ms=k6[(128, 1920)][6],
               ms_plain_bound_by_shape=by_shape(k6)),
        kernel("interaction_similarity_blocked_bwd",
               "interaction_similarity_blocked.cu",
               "pallas_similarity_blocked.py:342",
               paths("K7"), worst(k7, (128, 1920)),
               "A=128 T=64 B=1920 V=64 D=512 (text side from K6's "
               "residuals, the train step's form)",
               ms_plain_bound_by_shape=by_shape(k7)),
        kernel("frame_attention", "frame_attention.cu",
               "pallas_attention.py:290",
               paths("K8"), worst(k8, "vision ViT-L/14@336px"),
               "vision ViT-L/14@336px N=192 L=577 H=16",
               also_replaces=["pallas_attention.py:430",
                              "pallas_attention.py:496"],
               ms_plain_bound_library_by_shape=by_shape(k8)),
        kernel("frame_attention_bwd", "frame_attention.cu",
               "pallas_attention.py:329",
               paths("K9"), worst(k9, "vision ViT-L/14@336px"),
               "vision ViT-L/14@336px N=192 L=577 H=16",
               also_replaces=["pallas_attention.py:459",
                              "pallas_attention.py:525"],
               ms_plain_bound_library_by_shape=by_shape(k9)),
        kernel("attention_sublayer", "ln_attention_residual.cu",
               "pallas_block_attention.py:238",
               paths("K10"), worst(k10, "vision check"),
               "vision check N=768 L=50 D=768 H=12",
               also_replaces=["pallas_block_attention.py:300"],
               ms_plain_bound_library_by_shape=by_shape(k10)),
        kernel("attention_sublayer_bwd", "ln_attention_residual_bwd.cu",
               "pallas_block_attention.py:266",
               paths("K11"), worst(k11, "vision check"),
               "vision check N=768 L=50 D=768 H=12",
               also_replaces=["pallas_block_attention.py:327"],
               ms_plain_bound_library_by_shape=by_shape(k11)),
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
