"""Plain reference of NeighborRetr's training steps: the epoch-start bank
fill, then steps of the four losses against the bank, BertAdam (global and
per-tensor gradient clipping, moments without bias correction, decoupled
weight decay, the CLIP branch at lr · coef_lr, the warm-up schedule counted
from completed steps), the logit-scale clamp and the FIFO bank refresh.

The gradients are those of the whole batch, computed in row chunks so that
float32 activations fit on one card: the features are encoded without a
graph, the losses' backward gives their cotangents, and each chunk is
encoded again under autograd to carry its slice of them back into the
towers.  The result equals one monolithic backward.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from . import model as R
from .precision import Precision

FROZEN = ("clip.visual.conv1.weight",)
WEIGHT_NETS = ("text_weight_fc.", "video_weight_fc.")


def schedule(name: str, x: float, warmup: float) -> float:
    if name == "warmup_cosine":
        x = min(x, 1.0)
        return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi
                                                                   * x))
    if name == "warmup_constant":
        return x / warmup if x < warmup else 1.0
    if name == "warmup_linear":
        return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0),
                                                 0.0)
    raise ValueError(f"unknown schedule {name!r}")


def encode(P, batch, rows, cfg: dict, prec: Precision):
    t = R.encode_text(P, batch["text_ids"][rows], batch["text_mask"][rows],
                      cfg, prec)
    v = R.encode_video(P, batch["video"][rows], batch["video_mask"][rows],
                       cfg, prec)
    return t, v


def encode_chunked(P, batch, chunk: int, cfg: dict, prec: Precision):
    B = batch["text_ids"].shape[0]
    feats = [encode(P, batch, slice(s, s + chunk), cfg, prec)
             for s in range(0, B, chunk)]
    return (torch.cat([f[0] for f in feats]),
            torch.cat([f[1] for f in feats]))


def fill_bank(P, batches: Sequence[dict], n_fill: int, cfg: dict,
              prec: Precision, chunk: int) -> Dict[str, torch.Tensor]:
    """The bank after `n_fill` fill batches, the i-th of them
    batches[i % len(batches)], each written at offset i · batch."""
    with torch.no_grad():
        feats = [encode_chunked(P, b, chunk, cfg, prec)
                 for b in batches[:min(n_fill, len(batches))]]
    rows = [feats[i % len(feats)] for i in range(n_fill)]
    masks = [batches[i % len(batches)] for i in range(n_fill)]
    return {"feat_t": torch.cat([r[0] for r in rows]),
            "feat_v": torch.cat([r[1] for r in rows]),
            "mask_t": torch.cat([m["text_mask"] for m in masks]),
            "mask_v": torch.cat([m["video_mask"] for m in masks])}


class Trainer:
    """The reference's train state: parameters (float32 leaves), moments,
    completed steps and the bank."""

    def __init__(self, params: Dict[str, torch.Tensor], bank, cfg: dict,
                 prec: Precision, chunk: int):
        self.P = {n: t.detach().clone().requires_grad_(n not in FROZEN)
                  for n, t in params.items()}
        self.m = {n: torch.zeros_like(t) for n, t in self.P.items()
                  if n not in FROZEN}
        self.v = {n: torch.zeros_like(self.P[n]) for n in self.m}
        self.bank, self.cfg, self.prec, self.chunk = bank, cfg, prec, chunk
        self.step_count = 0

    def gradients(self, batch, noise):
        """(loss terms as floats, the features, every live leaf's
        gradient) of one batch."""
        cfg, P = self.cfg, self.P
        with torch.no_grad():
            t_feat, v_feat = encode_chunked(P, batch, self.chunk, cfg["model"],
                                            self.prec)
        leaves = (t_feat.requires_grad_(True), v_feat.requires_grad_(True))
        terms = R.losses(P, *leaves, batch["text_mask"], batch["video_mask"],
                         self.bank, noise, cfg["model"], cfg["loss"])
        live = [n for n in self.m]
        grads = torch.autograd.grad(terms["loss"], leaves + tuple(
            P[n] for n in live), allow_unused=True)
        g_t, g_v = grads[0], grads[1]
        acc = {n: (g if g is not None else torch.zeros_like(P[n]))
               for n, g in zip(live, grads[2:])}
        B = t_feat.shape[0]
        for s in range(0, B, self.chunk):
            rows = slice(s, s + self.chunk)
            out = encode(P, batch, rows, cfg["model"], self.prec)
            part = torch.autograd.grad(out, [P[n] for n in live],
                                       (g_t[rows], g_v[rows]),
                                       allow_unused=True)
            for n, g in zip(live, part):
                if g is not None:
                    acc[n] += g
        return ({k: float(v.detach()) for k, v in terms.items()},
                (t_feat.detach(), v_feat.detach()), acc)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """BertAdam; returns the clipped gradients, as the moments take
        them."""
        o = self.cfg["optim"]
        names = list(self.m)
        norms = torch.stack([grads[n].norm() for n in names])
        clipped = {}
        if o["max_grad_norm"] > 0:
            coef = torch.clamp(o["max_grad_norm"] / (norms.norm() + 1e-6),
                               max=1.0)
            for n, leaf in zip(names, norms):
                pn = coef * leaf
                s = coef * torch.clamp(o["max_grad_norm"] / (pn + 1e-6),
                                       max=1.0)
                clipped[n] = grads[n] * s
        else:
            clipped = dict(grads)
        mult = schedule(o["schedule"], self.step_count / float(o["t_total"]),
                        o["warmup_proportion"])
        for n in names:
            g, p = clipped[n], self.P[n]
            self.m[n].mul_(o["b1"]).add_(g, alpha=1.0 - o["b1"])
            self.v[n].mul_(o["b2"]).addcmul_(g, g, value=1.0 - o["b2"])
            upd = self.m[n] / (self.v[n].sqrt() + o["eps"])
            if o["weight_decay"] > 0 and not n.endswith("bias"):
                upd = upd + o["weight_decay"] * p
            lr = o["lr"] * (o["coef_lr"] if n.startswith("clip.") else 1.0)
            p.add_(upd, alpha=-lr * mult)
        self.P["clip.logit_scale"].clamp_(
            max=math.log(self.cfg["loss"]["max_logit_scale"]))
        self.step_count += 1
        return clipped

    def step(self, batch, noise):
        """One training step → (loss terms, the clipped gradients)."""
        terms, (t_feat, v_feat), grads = self.gradients(batch, noise)
        clipped = self.update(grads)
        cap = self.bank["feat_t"].shape[0]
        new = {"feat_t": t_feat, "feat_v": v_feat,
               "mask_t": batch["text_mask"], "mask_v": batch["video_mask"]}
        self.bank = {k: torch.cat([new[k], self.bank[k]])[:cap]
                     for k in self.bank}
        return terms, clipped


def run_steps(params, fill_batches: Sequence[dict], step_batches:
              Sequence[dict], cfg: dict, prec: Precision, chunk: int,
              noise_generator: torch.Generator) -> List[dict]:
    """The bank fill and one step a batch from `params` → per step the loss
    terms; the first step's entry also holds the clipped gradients
    ("grads") and the last one's the trainer ("trainer")."""
    bank = fill_bank(params, fill_batches, cfg["train"]["mb_batch"],
                     cfg["model"], prec, chunk)
    tr = Trainer(params, bank, cfg, prec, chunk)
    out = []
    for i, batch in enumerate(step_batches):
        B, W = batch["text_ids"].shape
        noise = (R.cluster_noise(B, W, batch["video_mask"].shape[1],
                                 cfg["model"], noise_generator)
                 if cfg["model"]["cluster_noise"] else None)
        terms, clipped = tr.step(batch, noise)
        rec = {"terms": terms}
        if i == 0:
            rec["grads"] = clipped
        out.append(rec)
    out[-1]["trainer"] = tr
    return out



@torch.no_grad()
def centrality_stage(P, t_feat, v_feat, tmask, vmask, bank,
                     dtype=torch.float64):
    """The bank centralities of one step (each text against the bank's
    videos, each video against the bank's texts) worked out in `dtype`
    from given features and bank (the program's own, when the check
    follows the program past its towers): the similarity family alone."""
    def c(x):
        return x.to(dtype)
    Q = {n: c(t) for n, t in P.items() if n.startswith(WEIGHT_NETS)}
    return R.bank_centralities(Q, *(c(x) for x in (t_feat, v_feat, tmask,
                                                   vmask)),
                               {k: c(x) for k, x in bank.items()})
