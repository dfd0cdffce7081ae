"""Model FLOP of one NeighborRetr training step, frozen.

A copy of the analytic count the program keeps, over a plain dict of sizes
(the same integers wherever heads are 64 wide and E is 512, as the
program's count assumes): each matrix product is 2·M·N·K; forward +
backward is 3x the forward (dW and dx each 2·M·N·K); elementwise work,
softmax and LayerNorm are left out; no rematerialisation is counted, so a
step that runs a tower's forward twice does no more model work; the frozen
patch embedding runs forward only.  The CTM term is rough (its small
matrices only).  At the MSR-VTT recipe's shapes, batch 96 and a bank of
384, it gives 30.64 TFLOP a step.

`sizes`: embed_dim, image_resolution, vision_layers, vision_width,
vision_patch_size, transformer_width, transformer_layers, temporal_layers,
max_words, max_frames, batch, bank.  An attention core is 2·2·N·L²·D a
layer at the tower's width D, whatever its heads; the temporal tower's
width is the embedding width E.
"""

from __future__ import annotations


def step_phase_flops(s: dict) -> dict:
    """Forward FLOP of one step by tower and loss-side phase."""
    B, W, F, R = s["batch"], s["max_words"], s["max_frames"], \
        s["image_resolution"]
    E, bank = s["embed_dim"], s["bank"]
    P = s["vision_patch_size"]
    NF = B * F
    Lv = (R // P) ** 2 + 1
    Dv = s["vision_width"]
    Mv = NF * Lv
    vis_attn = s["vision_layers"] * (
        2 * Mv * Dv * 3 * Dv + 2 * (2 * NF * Lv * Lv * Dv)
        + 2 * Mv * Dv * Dv)
    vis_mlp = s["vision_layers"] * 2 * (2 * Mv * Dv * 4 * Dv)
    stem = 2 * NF * (Lv - 1) * (P ** 2 * 3) * Dv
    vis_proj = 2 * NF * Dv * E
    Mt = B * W
    Dt = s["transformer_width"]
    txt = s["transformer_layers"] * (
        2 * Mt * Dt * 3 * Dt + 2 * (2 * B * W * W * Dt)
        + 2 * Mt * Dt * Dt + 2 * (2 * Mt * Dt * 4 * Dt)) + 2 * Mt * Dt * E
    tmp = s["temporal_layers"] * (
        2 * B * F * E * 3 * E + 2 * (2 * B * F * F * E)
        + 2 * B * F * E * E + 2 * (2 * B * F * E * 4 * E))
    sim_bb = 2 * (2 * B * B * W * F * E)
    sim_bank = 2 * (2 * B * bank * W * F * E)
    ctm = 2 * (2 * B * W * W * E + 2 * B * F * F * E)
    return dict(vis_attn_fwd=vis_attn, vis_mlp_fwd=vis_mlp, stem_fwd=stem,
                vis_proj_fwd=vis_proj, txt_fwd=txt, tmp_fwd=tmp,
                sim_bb_fwd=sim_bb, sim_bank_fwd=sim_bank, ctm_fwd=ctm)


def step_flops(s: dict) -> float:
    """Model FLOP of one whole training step (forward and backward, the
    frozen stem forward only)."""
    p = step_phase_flops(s)
    return 3 * (p["vis_attn_fwd"] + p["vis_mlp_fwd"] + p["txt_fwd"]
                + p["tmp_fwd"] + p["sim_bb_fwd"] + p["sim_bank_fwd"]
                + p["ctm_fwd"]) + p["stem_fwd"] + 3 * p["vis_proj_fwd"]
