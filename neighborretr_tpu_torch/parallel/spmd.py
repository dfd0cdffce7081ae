"""The explicit row-sharded loss form over a data group (↔ neighborretr_tpu/
parallel/spmd.py).

The gathered form (train/step.py) computes the [B, B] and [B, M]
similarity matrices on every rank from the gathered features.  This form
gives each rank its rows only:

  per rank (data group of W ranks, B = W·B_local):
    1. encode the LOCAL batch rows (the towers' kernels on the rank's card),
    2. all-gather the token features and masks (differentiable),
    3. compute the rank's ROW BLOCK of the in-batch similarity [B_local, B]
       and of the two memory-bank matrices [B_local, M]: the bank rows run
       the similarity kernels under autograd (K2 with K5 behind it at the
       short shapes, K6 with K7 at the long ones); the in-batch rows follow
       the gathered form's gating (plain at the short shapes, K6 at
       T·V >= 2048), so the two forms compute the same S,
    4. all-gather those rows (differentiable).

The gathered matrices and features are the same on every rank, so the four
losses are then the single-device code (train/step.py::composed_losses),
and gradients flow back through the gathers (parallel/mesh.py::all_gather).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import Config
from ..losses import hubness
from ..models import neighborretr as M
from ..utils.spans import span
from . import mesh as pmesh


def gather_features_and_rows(model: M.NeighborRetr, cfg: Config,
                             batch: Dict[str, torch.Tensor], bank,
                             mesh: pmesh.DataGroup, kernels: bool = True):
    """The rank-local computation → (t_feat, v_feat, t_mask, v_mask, s_local,
    bank_t2v, bank_v2t), each of global shape and the same on every
    rank."""
    # the kernels are legal per rank (↔ `_resolve_kernels`, which exists
    # because GSPMD cannot partition a Pallas call): a rank holds whole
    # tensors on its own card, so the one-device rules hold, `use_pallas`
    # for the similarity family and `resolve_fused_attention` for the towers
    sim_kernels = M.similarity_kernels(cfg.model, kernels)

    # 1. local encode
    with span("nr::step.towers"):
        t_l, v_l = model.get_text_video_feat(
            batch["text_ids"], batch["text_mask"], batch["video"],
            batch["video_mask"], kernels)
    tm_l = batch["text_mask"].float()
    vm_l = batch["video_mask"].float()

    # 2. feature gather (differentiable; backward: all-reduce, then slice)
    t_g, v_g, tm_g, vm_g = (pmesh.all_gather(x, mesh)
                            for x in (t_l, v_l, tm_l, vm_l))

    # 3. row blocks, in sim_dtype where the gathered form takes it (the
    # long in-batch rows and the bank rows)
    sim_dtype = M.similarity_dtype(cfg.model)
    long_tokens = t_l.shape[1] * v_g.shape[1] >= 2048
    s_rows = M.local_similarity(model, t_l, v_g, tm_l, vm_g,
                                sim_kernels and long_tokens,
                                sim_dtype if long_tokens else "float32")
    bank_t2v_rows = M.local_similarity(model, t_l, bank.feat_v, tm_l,
                                       bank.mask_v, sim_kernels,
                                       sim_dtype)                 # [B_l, M]
    bank_v2t_rows = M.local_similarity(model, bank.feat_t, v_l, bank.mask_t,
                                       vm_l, sim_kernels, sim_dtype).T

    # 4. gather the rows → the global matrices
    s_local, bank_t2v, bank_v2t = (
        pmesh.all_gather(x, mesh)
        for x in (s_rows, bank_t2v_rows, bank_v2t_rows))
    return t_g, v_g, tm_g, vm_g, s_local, bank_t2v, bank_v2t


def compute_losses_spmd(model: M.NeighborRetr, cfg: Config,
                        batch: Dict[str, torch.Tensor], bank, noise,
                        mesh: pmesh.DataGroup, kernels: bool = True,
                        axis: str = "data"):
    """Drop-in for train/step.compute_losses on a data group: `batch` is
    this rank's rows → (total, aux), the same on every rank."""
    from ..train.step import composed_losses

    if len(mesh.axis_names) > 1:
        # row-sharding one axis of a multi-axis mesh would encode the batch
        # once per replica group and sum the parameter gradients over the
        # whole mesh: gradients scaled by the replica factor
        raise ValueError(
            f"explicit_spmd requires a 1-D ('{axis}',) mesh; got axes "
            f"{mesh.axis_names} — use the gathered form on hybrid/multi-axis "
            "meshes")
    if axis not in mesh.axis_names:
        raise ValueError(
            f"data_axis '{axis}' does not name the mesh axis "
            f"{mesh.axis_names} — the explicit form's collectives run over "
            "that axis")

    (t_feat, v_feat, t_mask, v_mask, s_local, bank_t2v,
     bank_v2t) = gather_features_and_rows(model, cfg, batch, bank, mesh,
                                          kernels)
    lcfg = cfg.loss

    def neighbor_loss():
        return 0.5 * (
            hubness.neighbor_adjusting_loss(
                s_local, bank_v2t, lcfg.num_neighbors, lcfg.temperature)
            + hubness.neighbor_adjusting_loss(
                s_local.T, bank_t2v, lcfg.num_neighbors, lcfg.temperature))

    return composed_losses(model, cfg, t_feat, v_feat, t_mask, v_mask,
                           s_local, noise, neighbor_loss)
