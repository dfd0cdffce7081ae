"""Analytic matmul FLOP counts of the training step (↔
neighborretr_tpu/utils/flops.py, the same formulas over the port's own
config).

Analytic, not counted by a profiler: hand-written kernels are opaque to a
cost model, and a profiler's count of a backward is not the algebraic
dW + dx = 2x forward.  Each matmul is 2·M·N·K, forward + backward = 3x
forward (dW and dx each 2·M·N·K); elementwise, softmax and LayerNorm
FLOPs are left out, so every bound derived from these counts is
conservative.  For the MSR-VTT recipe's shapes at batch 96 and a bank of
384 the formula gives 30.64 TFLOP a step (319.2 GFLOP a pair).

The math counted is the reference's own (the same towers and losses), so
the figure a pair holds for the PyTorch reference too.
"""

from __future__ import annotations

from ..core.config import Config


def analytic_step_phase_flops(cfg: Config) -> dict:
    """Per-phase analytic FORWARD matmul FLOPs for one training step at
    cfg.train.batch_size, by tower and loss-side phase."""
    mcfg = cfg.model
    c = mcfg.clip
    B = cfg.train.batch_size
    W, F, R = mcfg.max_words, mcfg.max_frames, c.image_resolution
    E = c.embed_dim
    M_BANK = cfg.train.memory_bank_capacity

    NF = B * F                                       # frames
    Lv = (R // c.vision_patch_size) ** 2 + 1         # vision tokens/frame
    Dv, Hv = c.vision_width, c.vision_width // 64
    Mv = NF * Lv
    vis_attn_fwd = c.vision_layers * (
        2 * Mv * Dv * 3 * Dv                         # qkv
        + 2 * (2 * NF * Hv * Lv * Lv * 64)           # QK^T + PV
        + 2 * Mv * Dv * Dv)                          # out proj
    vis_mlp_fwd = c.vision_layers * 2 * (2 * Mv * Dv * 4 * Dv)
    stem_fwd = 2 * NF * (Lv - 1) * (c.vision_patch_size ** 2 * 3) * Dv
    vis_proj_fwd = 2 * NF * Dv * E                   # CLS @ proj

    Mt = B * W
    Dt, Ht = c.transformer_width, c.transformer_heads
    txt_fwd = c.transformer_layers * (
        2 * Mt * Dt * 3 * Dt + 2 * (2 * B * Ht * W * W * 64)
        + 2 * Mt * Dt * Dt + 2 * (2 * Mt * Dt * 4 * Dt)) \
        + 2 * Mt * Dt * E                            # per-token projection
    tmp_fwd = mcfg.temporal_layers * (
        2 * B * F * E * 3 * E + 2 * (2 * B * 8 * F * F * 64)
        + 2 * B * F * E * E + 2 * (2 * B * F * E * 4 * E))

    # loss side: B x B token-interaction (both einsum orders in fwd) + bank
    # matrices + CTM cross-attn (small) — matmul terms only
    sim_bb_fwd = 2 * (2 * B * B * W * F * E)
    sim_bank_fwd = 2 * (2 * B * M_BANK * W * F * E)
    ctm_fwd = 2 * (2 * B * W * W * E + 2 * B * F * F * E)  # rough

    return dict(vis_attn_fwd=vis_attn_fwd, vis_mlp_fwd=vis_mlp_fwd,
                stem_fwd=stem_fwd, vis_proj_fwd=vis_proj_fwd,
                txt_fwd=txt_fwd, tmp_fwd=tmp_fwd, sim_bb_fwd=sim_bb_fwd,
                sim_bank_fwd=sim_bank_fwd, ctm_fwd=ctm_fwd)


def analytic_step_flops(cfg: Config) -> float:
    """Total analytic matmul FLOPs for ONE full training step
    (fwd + bwd + the frozen-stem forward-only term) at
    cfg.train.batch_size: 30.64 TF at batch 96 / bank 384 on the MSR-VTT
    recipe's shapes."""
    p = analytic_step_phase_flops(cfg)
    return 3 * (p["vis_attn_fwd"] + p["vis_mlp_fwd"] + p["txt_fwd"]
                + p["tmp_fwd"] + p["sim_bb_fwd"] + p["sim_bank_fwd"]
                + p["ctm_fwd"]) \
        + p["stem_fwd"] + 3 * p["vis_proj_fwd"]     # stem frozen: fwd only


def analytic_pair_flops(cfg: Config) -> float:
    """Analytic per-video-text-pair step FLOPs (flagship: 319.2 GFLOP)."""
    return analytic_step_flops(cfg) / cfg.train.batch_size
