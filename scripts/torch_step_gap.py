#!/usr/bin/env python3
"""Where do a kernel train step and a plain train step part on the card?

    python3 scripts/torch_step_gap.py [--device cuda|cpu] [--tiny] [--long]
                                      [--steps N] [--deterministic]

`chip_smoke.py` runs the train path twice from the same weights, through the
hand-written kernels and through their plain versions.  The first update of
the faithful BertAdam schedule is zero, so steps 1 and 2 of both runs take
their gradients at bit-identical weights; what differs between the runs is
the bf16 rounding inside the towers, which reaches the gradient two ways:
through the arithmetic (features, memory bank), and through the discrete
decisions taken on those features (DPC-KNN cluster ids, the neighbor loss's
top-k masks).  This script separates the two.  For each step at the start
weights it takes the full gradient of

  K   kernels, the kernel run's bank, its own decisions
  P   plain, the plain run's bank, its own decisions
  Pb  plain, the KERNEL run's bank, its own decisions
  Pd  plain, the plain run's bank, the KERNEL run's decisions replayed
  Pc  as Pd, but only the cluster ids replayed
  Pm  as Pd, but only the neighbour masks replayed
  Pbd plain, the kernel run's bank and decisions

and prints the gradient norm of each, its relative distance to K's, the
relative L2 distance of the whole gradient to K's, how many decisions
differ between K and P, and the tensors that carry most of |K - P|².  K is
taken three times: again at once, and again straight after another batch's
backward.  Equal bits in both show that no kernel keeps state between calls
and none sums in a changing order; torch's own scatter-adds (embedding
backward, `index_add_`) use float atomics on CUDA, so equal bits need
--deterministic, which asks torch for its ordered forms.  With --device cpu
--tiny the kernels' wrappers run their plain versions (a rehearsal of the
control flow only).

--long takes the long-token recipe's shapes (64 words x 64 frames; batch 16
and a bank of 240 so that one monolithic backward fits; --batch 128
--micro_batches 8 takes the trainer's own step instead), where the in-batch
matrix and both bank matrices go through the blocked similarity.  Its
backward routes every max to one winning token, and on synthetic videos,
whose 64 noise frames give near-identical features, the winners are decided
by differences as small as the towers' bf16 rounding.  Two more variants
separate that from a fault of the kernels:

  Kp  kernel towers, PLAIN blocked similarity, K's decisions: the same
      features as K, so the same winners; what is left is K6/K7 against
      their plain version inside a real step
  Pr  as Pd, and the plain backward routes by K's winners (replayed)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import decisions                                   # noqa: E402
from neighborretr_tpu_torch.core import config as C                # noqa: E402
from neighborretr_tpu_torch.data.datasets.synthetic import \
    make_synthetic_batch                                           # noqa: E402
from neighborretr_tpu_torch.models import neighborretr as M        # noqa: E402
from neighborretr_tpu_torch.models.weights_io import init_model    # noqa: E402
from neighborretr_tpu_torch.train import bertadam                  # noqa: E402
from neighborretr_tpu_torch.train import memory_bank as MB         # noqa: E402
from neighborretr_tpu_torch.train import step as TS                # noqa: E402

DECISIONS = ("text ctm0 ids", "text ctm1 ids", "video ctm0 ids",
             "video ctm1 ids", "neighbor mask t2v", "neighbor mask v2t")
LOSS_TERMS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
              "kl_loss")


def gradient(model, cfg, batch, bank, noise, kernels, replay=None,
             routing=None, replay_routing=None, plain_similarity=False):
    """One forward and backward at the model's weights → (gradients by name,
    the decisions taken, the loss terms and fresh features).  routing /
    replay_routing: see chip_smoke.decisions; plain_similarity: the local
    similarity through its plain version whatever `kernels` says."""
    log: list = []
    model.zero_grad(set_to_none=True)
    real_sim = M.local_similarity
    if plain_similarity:
        M.local_similarity = (
            lambda model, tf, vf, tm, vm, kernels=True, sim_dtype="float32":
            real_sim(model, tf, vf, tm, vm, False, sim_dtype))
    try:
        with decisions(log, replay, routing, replay_routing):
            if cfg.train.micro_batches > 1:     # GradCache, as train_step
                aux = TS._microbatched_backward(model, cfg, batch, bank,
                                                noise, kernels)
            else:
                total, aux = TS.compute_losses(model, cfg, batch, bank, noise,
                                               kernels)
                total.backward()
    finally:
        M.local_similarity = real_sim
    grads = {n: (p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p))
             for n, p in model.named_parameters()
             if not bertadam.is_frozen(n)}
    model.zero_grad(set_to_none=True)
    return grads, log, aux


def norm(grads) -> float:
    return bertadam.clip_effective_norm(grads).item()


def distance(a, b) -> float:
    """|a - b| / |b| over the whole gradient."""
    d2 = sum(((a[n] - b[n]).double() ** 2).sum() for n in b)
    return (d2.sqrt() / max(norm(b), 1e-30)).item()


def same_bits(a, b) -> str:
    off = [n for n in a if not torch.equal(a[n], b[n])]
    if not off:
        return f"bit-equal in all {len(a)} tensors"
    return (f"DIFFERS in {len(off)} of {len(a)} tensors, |Δ| / |K| "
            f"{distance(b, a):.3g} (first: {', '.join(off[:4])})")


def differing(a, b) -> str:
    out = []
    for name, x, y in zip(DECISIONS, a, b):
        if isinstance(x, tuple):            # (neighbor, extended) masks
            x, y = x[0], y[0]
            rows = int((x != y).any(dim=-1).sum())
            out.append(f"{name}: {rows} of {x.shape[0]} rows")
        else:
            out.append(f"{name}: {int((x != y).sum())} of {x.numel()} tokens "
                       f"in {int((x != y).any(dim=-1).sum())} samples")
    return "; ".join(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny fp32 model and batch 8 (CPU rehearsal)")
    ap.add_argument("--long", action="store_true",
                    help="64 words x 64 frames, batch 16, bank 240: the "
                         "blocked similarity's routing taken apart")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default: the recipe's 128, 16 under "
                         "--long, 8 under --tiny)")
    ap.add_argument("--micro_batches", type=int, default=1,
                    help="take each gradient in this many micro-batches "
                         "(GradCache), as train_step does: --long --batch 128 "
                         "--micro_batches 8 is the trainer's step")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    ap.add_argument("--steps", type=int, default=2,
                    help="steps at the start weights to take apart (1 or 2)")
    args = ap.parse_args()
    dev = args.device
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        # an op with no ordered form warns and names itself
        torch.use_deterministic_algorithms(True, warn_only=True)
        print("torch.use_deterministic_algorithms(True, warn_only=True)")
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.tiny:
        cfg = C.Config(
            model=dataclasses.replace(
                C.ModelConfig.tiny(max_words=8, max_frames=4),
                cluster_noise=True),
            loss=C.LossConfig(num_neighbors=3),
            data=C.DataConfig(max_words=8, max_frames=4),
            train=C.TrainConfig(batch_size=8, mb_batch=2))
    elif args.long:
        cfg = C.Config(
            model=C.ModelConfig(max_words=64, max_frames=64),
            data=C.DataConfig(max_words=64, max_frames=64),
            train=C.TrainConfig(batch_size=16, mb_batch=15))
    else:
        cfg = C.Config()
    if args.tiny and args.long:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                C.ModelConfig.tiny(max_words=64, max_frames=32),
                cluster_noise=True),
            data=C.DataConfig(max_words=64, max_frames=32))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=args.batch or cfg.train.batch_size,
        micro_batches=args.micro_batches))
    long_tokens = cfg.model.max_words * cfg.model.max_frames >= 2048
    m, B, n_fill = cfg.model, cfg.train.batch_size, cfg.train.mb_batch
    first_lr = bertadam.SCHEDULES[cfg.optim.schedule](
        0.0, cfg.optim.warmup_proportion)
    print(f"schedule {cfg.optim.schedule}(0) = {first_lr}: the first update "
          f"is {'zero, steps 1 and 2 share their weights' if first_lr == 0 else 'NOT zero'}")
    if first_lr != 0 and args.steps > 1:
        raise SystemExit("step 2 is not at the start weights in this config")

    # the batches, generator seed and order of chip_smoke.py's train run
    model = init_model(m, seed=0, device=dev)
    for name, p in model.named_parameters():
        p.requires_grad_(not bertadam.is_frozen(name))
    host = []
    for seed in range(7):
        b = make_synthetic_batch(m, B, seed=seed)
        b["idx"] = b["idx"] + B * seed
        host.append(TS.to_device(b, dev))
    fill, steps = host[:4], host[4:]

    banks = {}
    for kernels in (True, False):
        bank = MB.create(cfg.train.memory_bank_capacity, m.max_words,
                         m.max_frames, m.width, device=dev)
        for i in range(n_fill):
            bank = TS.fill_bank_step(model, bank, fill[i % len(fill)], cfg,
                                     i * B, kernels)
        banks[kernels] = bank
    d = (banks[True].feat_v - banks[False].feat_v).abs().max().item()
    print(f"bank after the fill, kernels vs plain: max |Δ feat_v| {d:.3g} "
          f"(max |feat_v| {banks[False].feat_v.abs().max().item():.3g})")

    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(args.steps):
        batch = steps[i]
        noise = (M.draw_cluster_noise(m, B, gen, dev) if m.cluster_noise
                 else None)
        print(f"== step {i + 1} (weights = start, batch {i + 1})")
        route_k: dict = {}
        K, dec_k, aux_k = gradient(model, cfg, batch, banks[True], noise, True,
                                   routing=route_k if long_tokens else None)
        K2 = gradient(model, cfg, batch, banks[True], noise, True)[0]
        print("  K taken again at once: " + same_bits(K, K2))
        # and straight after another batch went through the kernels: a
        # kernel that kept state between calls would show here
        gradient(model, cfg, steps[(i + 1) % len(steps)], banks[True], noise,
                 True)
        K2 = gradient(model, cfg, batch, banks[True], noise, True)[0]
        print("  K taken again after another batch's backward: "
              + same_bits(K, K2))
        del K2
        route_p: dict = {}
        P, dec_p, aux_p = gradient(model, cfg, batch, banks[False], noise,
                                   False,
                                   routing=route_p if long_tokens else None)
        print("  decisions that differ, K vs P: " + differing(dec_k, dec_p))
        for key in sorted(route_k):
            for side, a, b in zip(("over v", "over t"), route_k[key],
                                  route_p[key]):
                print(f"  winners {side} that differ, K vs P, matrix {key}: "
                      f"{int((a != b).sum())} of {a.numel()}")
        for n in LOSS_TERMS:
            a, b = aux_k[n].item(), aux_p[n].item()
            print(f"  {n}: K {a:.6f} P {b:.6f} rel {abs(a - b) / abs(b):.3g}")

        nk = norm(K)
        print(f"  K   grad_norm {nk:.6f}")
        variants = (("P  ", P),
                    ("Pb ", gradient(model, cfg, batch, banks[True], noise,
                                     False)[0]),
                    ("Pd ", gradient(model, cfg, batch, banks[False], noise,
                                     False, dec_k)[0]),
                    ("Pc ", gradient(model, cfg, batch, banks[False], noise,
                                     False, dec_k[:4] + [None, None])[0]),
                    ("Pm ", gradient(model, cfg, batch, banks[False], noise,
                                     False, [None] * 4 + dec_k[4:])[0]),
                    ("Pbd", gradient(model, cfg, batch, banks[True], noise,
                                     False, dec_k)[0]))
        if long_tokens:
            variants += (
                ("Kp ", gradient(model, cfg, batch, banks[True], noise, True,
                                 dec_k, plain_similarity=True)[0]),
                ("Pr ", gradient(model, cfg, batch, banks[False], noise,
                                 False, dec_k, replay_routing=route_k)[0]),
                ("Pbr", gradient(model, cfg, batch, banks[True], noise,
                                 False, dec_k, replay_routing=route_k)[0]))
        for tag, G in variants:
            n_ = norm(G)
            print(f"  {tag} grad_norm {n_:.6f} rel to K {abs(n_ - nk) / nk:.3g}"
                  f"; |G - K| / |K| {distance(G, K):.3g}")

        share = {n: ((K[n] - P[n]).double() ** 2).sum().item() for n in K}
        whole = sum(share.values())
        print("  tensors that carry most of |K - P|²:")
        for n in sorted(share, key=share.get, reverse=True)[:8]:
            rel = ((K[n] - P[n]).norm() / P[n].norm().clamp_min(1e-30)).item()
            print(f"    {share[n] / max(whole, 1e-300):6.1%}  {n}: |K| "
                  f"{K[n].norm().item():.4g} |P| {P[n].norm().item():.4g} "
                  f"rel L2 {rel:.3g}")
        del variants, K, P

        # both banks move on as the step's FIFO refresh moves them
        with torch.no_grad():
            for kernels, aux in ((True, aux_k), (False, aux_p)):
                banks[kernels] = MB.fifo_update(
                    banks[kernels], batch["idx"].to(torch.int32),
                    aux["text_feat"], aux["video_feat"],
                    batch["text_mask"].float(), batch["video_mask"].float())


if __name__ == "__main__":
    main()
