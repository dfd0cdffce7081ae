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

With `moments_placement="host"` (`place_moments`) the moments live in pinned
host memory between steps and the update still runs on the card: they
stream in buckets of about `HOST_BUCKET_BYTES` on the device's copy stream
(utils/host_memory.py), at most two buckets on the card at a time, each
bucket takes the same `_foreach` math as the device placement, and streams
back without blocking the host.  The norms are the gradients' on the card.
The update is elementwise, so the bucketing changes no bit: parameters and
moments equal the device placement's after every step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..core.config import OptimizerConfig
from ..parallel.mesh import ModelPlacement, local, squares_over_shards
from ..utils import host_memory

FROZEN = ("clip.visual.conv1.weight",)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# moments (m and v together) a bucket of the host placement brings to the
# card; a larger leaf (the token embedding's 101 MB) is a bucket alone
HOST_BUCKET_BYTES = 128 << 20


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


def place_moments(state: BertAdamState, placement: str,
                  device=None) -> BertAdamState:
    """The moments in their configured home between steps: pinned host
    memory under "host" (the moments' update still runs on `device`, which
    must be a CUDA device), unchanged under "device"."""
    if placement != "host":
        return state
    require_host_placement(device)
    return state._replace(
        m={n: host_memory.pinned(t) for n, t in state.m.items()},
        v={n: host_memory.pinned(t) for n, t in state.v.items()})


def require_host_placement(device) -> None:
    """Raises ValueError (the JAX package's words first) unless `device`
    is a CUDA device, which host-placed moments need."""
    host_memory.require_cuda(
        device, "each moment",
        "moments_placement='host' needs a TPU/GPU backend")


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
    if any(host_memory.is_host_resident(state.m[n]) for n in live):
        _host_moments_update(cfg, live, p, g, state, lr_mult)
    else:
        _moments_update(cfg, live, p, g, [state.m[n] for n in live],
                        [state.v[n] for n in live], lr_mult)
    return BertAdamState(step=state.step + 1, m=state.m, v=state.v)


def _moments_update(cfg: OptimizerConfig, names, p, g, m_store, v_store,
                    lr_mult: float) -> None:
    """The moments (`m_store`, `v_store`, in place, in their dtype) and the
    parameters `p` (in place) of `names` from the clipped gradients `g`."""
    fp32 = all(x.dtype == torch.float32 for x in m_store)
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
        decayed = [i for i, n in enumerate(names) if not is_no_decay(n)]
        torch._foreach_add_([update[i] for i in decayed],
                            [p[i] for i in decayed], alpha=cfg.weight_decay)
    for clip_branch in (True, False):
        idx = [i for i, n in enumerate(names)
               if is_clip_branch(n) == clip_branch]
        if idx:
            lr = cfg.lr * (cfg.coef_lr if clip_branch else 1.0)
            torch._foreach_add_([p[i] for i in idx], [update[i] for i in idx],
                                alpha=-lr * lr_mult)
    if not fp32:
        torch._foreach_copy_(m_store, m)
        torch._foreach_copy_(v_store, v)


def _buckets(sizes, limit: int):
    """Consecutive index ranges whose sizes sum to at most `limit` (a
    larger size is a range alone)."""
    out, cur, held = [], [], 0
    for i, n in enumerate(sizes):
        if cur and held + n > limit:
            out.append(cur)
            cur, held = [], 0
        cur.append(i)
        held += n
    return out + ([cur] if cur else [])


def _host_moments_update(cfg: OptimizerConfig, live, p, g,
                         state: BertAdamState, lr_mult: float) -> None:
    """`_moments_update` over moments in pinned host memory, a bucket at a
    time: two device slots take turns, bucket k + 1 uploads on the copy
    stream while bucket k's math runs on the compute stream, and bucket k
    streams back into its host tensors once its math is done.  All copies
    run on one copy stream, so a slot is refilled only after its last
    bucket went back, and the next step's upload reads the host moments
    only after this step's download wrote them.  The slots are allocated
    on the copy stream, so the first two uploads need not wait for the
    backward still running on the card."""
    device = p[0].device
    compute = torch.cuda.current_stream(device)
    side = host_memory.copy_stream(device)
    host = [(state.m[n], state.v[n]) for n in live]
    dtype = host[0][0].dtype
    buckets = _buckets([2 * m.numel() * m.element_size() for m, _ in host],
                       HOST_BUCKET_BYTES)
    width = max(sum(host[i][0].numel() for i in b) for b in buckets)
    with torch.cuda.stream(side):  # the slots' memory: free in its order
        slots = [torch.empty(2 * width, dtype=dtype, device=device)
                 for _ in range(min(2, len(buckets)))]

    def views(k):
        """Bucket k's (m, v) device tensors inside its slot."""
        flat, at, m, v = slots[k % 2], 0, [], []
        for i in buckets[k]:
            n = host[i][0].numel()
            m.append(flat[at:at + n].view(host[i][0].shape))
            v.append(flat[width + at:width + at + n].view(host[i][1].shape))
            at += n
        return m, v

    def upload(k):
        m, v = views(k)
        with torch.cuda.stream(side):
            for i, dm, dv in zip(buckets[k], m, v):
                dm.copy_(host[i][0], non_blocking=True)
                dv.copy_(host[i][1], non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return m, v, done

    pending = upload(0)
    for k, b in enumerate(buckets):
        m, v, uploaded = pending
        if k + 1 < len(buckets):
            pending = upload(k + 1)
        compute.wait_event(uploaded)
        _moments_update(cfg, [live[i] for i in b], [p[i] for i in b],
                        [g[i] for i in b], m, v, lr_mult)
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            for i, dm, dv in zip(b, m, v):
                host[i][0].copy_(dm, non_blocking=True)
                host[i][1].copy_(dv, non_blocking=True)
    for slot in slots:
        slot.record_stream(compute)


def current_lr(state: BertAdamState, cfg: OptimizerConfig,
               t_total: int) -> float:
    return cfg.lr * SCHEDULES[cfg.schedule](state.step / float(t_total),
                                            cfg.warmup_proportion)
