"""BertAdam (↔ neighborretr_tpu/train/bertadam.py; the reference's
optimizer stack), over a model's named parameters:

  1. global grad-norm clip to max_grad_norm over all trainable parameters,
  2. per-parameter grad-norm clip to the same bound inside the step,
  3. Adam moments WITHOUT bias correction,
  4. update = m / (sqrt(v) + eps) + weight_decay · p (decoupled),
  5. lr = base_lr(group) · schedule(step / t_total, warmup), where `step`
     counts COMPLETED steps: the first update runs at schedule(0), which is
     0 for the warm-up schedules — a reference quirk kept,
  6. groups: {decay, no-decay} × {clip, non-clip}; the CLIP branch's lr is
     lr · coef_lr; only names ending in `bias` are no-decay, so LayerNorm
     scales ARE decayed (the reference's no_decay patterns never match its
     own LayerNorm names),
  7. the frozen vision patch embedding (`clip.visual.conv1.weight`) gets no
     update and stays out of both norms.

Moments are stored in `moments_dtype` (fp32 or bf16); the update runs in
fp32.  Parameters are updated in place.  On a model-sharded placement
(parallel/mesh.py) the parameters, gradients and moments are the rank's
local tensors, and both norms are the full model's: a leaf split over ranks
sums its squares over its shards exactly once, a stage's leaves are summed
over the stages, a replicated leaf counts once (`squares_over_shards`), so
every rank clips by the same coefficients.  The update walks all tensors at
once with torch's multi-tensor (`_foreach`) ops: a loop over ~400 tensors of
~15 small launches each leaves the card waiting for the host.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..core.config import OptimizerConfig
from ..parallel.mesh import ModelPlacement, local, squares_over_shards

FROZEN = ("clip.visual.conv1.weight",)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def is_frozen(name: str) -> bool:
    return name in FROZEN


def is_no_decay(name: str) -> bool:
    return name.endswith("bias")


def is_clip_branch(name: str) -> bool:
    return name.startswith("clip.")


def warmup_cosine(x: float, warmup: float) -> float:
    x = min(x, 1.0)    # the raw cosine rises again past t_total
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


SCHEDULES: Dict[str, Callable[[float, float], float]] = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


class BertAdamState(NamedTuple):
    step: int                      # completed steps
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def bert_adam_init(params: Dict[str, torch.Tensor],
                   moments_dtype: str = "float32") -> BertAdamState:
    """Zero moments, each shaped as its parameter's local tensor."""
    dt = DTYPES[moments_dtype]
    return BertAdamState(
        step=0,
        m={n: torch.zeros_like(local(p), dtype=dt) for n, p in params.items()},
        v={n: torch.zeros_like(local(p), dtype=dt) for n, p in params.items()})


def _norms(names, g, placement: Optional[ModelPlacement]):
    """(each leaf's norm, the global norm) over the full model."""
    norms = torch.stack(torch._foreach_norm(g))
    if placement is None:
        return norms, torch.linalg.vector_norm(norms)
    leaf, total = squares_over_shards(names, norms ** 2, placement)
    return leaf.sqrt(), total.sqrt()


def clip_effective_norm(grads: Dict[str, torch.Tensor],
                        placement: Optional[ModelPlacement] = None
                        ) -> torch.Tensor:
    """Global norm over the non-frozen gradients: the norm the clipping
    sees, comparable to max_grad_norm."""
    names = [n for n in grads if not is_frozen(n)]
    return _norms(names, [grads[n].float() for n in names], placement)[1]


@torch.no_grad()
def bert_adam_update(grads: Dict[str, torch.Tensor], state: BertAdamState,
                     params: Dict[str, torch.Tensor], cfg: OptimizerConfig,
                     t_total: int,
                     placement: Optional[ModelPlacement] = None
                     ) -> BertAdamState:
    """One step over `params` (name → tensor, updated in place) from `grads`
    (same names, local tensors; frozen names may be absent); `placement`:
    the model's, for the norms over its shards.  Returns the new state."""
    lr_mult = SCHEDULES[cfg.schedule](state.step / float(t_total),
                                      cfg.warmup_proportion)
    live = [n for n in params if not is_frozen(n)]
    p = [local(params[n]) for n in live]
    g = [grads[n].float() for n in live]
    if cfg.max_grad_norm > 0:
        # both clip stages from one read of the gradients: the global norm
        # gives stage 1's coefficient, and stage 2 clips coef·|g_l| per tensor
        leaf, total = _norms(live, g, placement)
        coef = torch.clamp(cfg.max_grad_norm / (total + 1e-6), max=1.0)
        pnorm = coef * leaf
        scale = coef * torch.clamp(cfg.max_grad_norm / (pnorm + 1e-6),
                                   max=1.0)
        g = torch._foreach_mul(g, list(scale.unbind()))
    fp32 = all(state.m[n].dtype == torch.float32 for n in live)
    m_store = [state.m[n] for n in live]
    v_store = [state.v[n] for n in live]
    m = m_store if fp32 else [x.float() for x in m_store]
    v = v_store if fp32 else [x.float() for x in v_store]
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, g, alpha=1.0 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - cfg.b2)
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, cfg.eps)
    update = torch._foreach_div(m, denom)
    if cfg.weight_decay > 0:
        decayed = [i for i, n in enumerate(live) if not is_no_decay(n)]
        torch._foreach_add_([update[i] for i in decayed],
                            [p[i] for i in decayed], alpha=cfg.weight_decay)
    for clip_branch in (True, False):
        idx = [i for i, n in enumerate(live)
               if is_clip_branch(n) == clip_branch]
        if idx:
            lr = cfg.lr * (cfg.coef_lr if clip_branch else 1.0)
            torch._foreach_add_([p[i] for i in idx], [update[i] for i in idx],
                                alpha=-lr * lr_mult)
    if not fp32:
        torch._foreach_copy_(m_store, m)
        torch._foreach_copy_(v_store, v)
    return BertAdamState(step=state.step + 1, m=state.m, v=state.v)


def current_lr(state: BertAdamState, cfg: OptimizerConfig,
               t_total: int) -> float:
    return cfg.lr * SCHEDULES[cfg.schedule](state.step / float(t_total),
                                            cfg.warmup_proportion)
