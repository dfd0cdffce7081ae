"""Retrieval metrics: R@K, median / mean rank, the multi-sentence protocols
(↔ neighborretr_tpu/train/metrics.py).

Ranks are counted on the device as the number of STRICTLY greater scores
in the query's row (column for video→text): the first-occurrence rank, one
entry per query.  The reference's host `compute_metrics` emits one rank
entry per tying column, which inflates its denominator when scores tie
exactly; the JAX package keeps that form for parity tests only and ranks
on the device as here.  The port's `compute_metrics` is the host-array form
of the device ranks.  The tie counts say on how many rows the two forms
would differ.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch


def device_ranks(similarity: torch.Tensor) -> torch.Tensor:
    """0-based rank of the diagonal in each row of [N, N]: the count of
    strictly greater entries."""
    diag = similarity.diagonal()[:, None]
    return (similarity > diag).sum(dim=1)


def device_ranks_both(similarity: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(text→video ranks over rows, video→text ranks over columns)."""
    diag = similarity.diagonal()
    return ((similarity > diag[:, None]).sum(dim=1),
            (similarity > diag[None, :]).sum(dim=0))


def device_ties_both(similarity: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows (columns) whose diagonal score ties at least one other entry."""
    diag = similarity.diagonal()
    t2v = ((similarity == diag[:, None]).sum(dim=1) > 1).sum()
    v2t = ((similarity == diag[None, :]).sum(dim=0) > 1).sum()
    return t2v, v2t


def _own_video(sim_3d: torch.Tensor) -> torch.Tensor:
    """[V, C, V] → [V, C, 1]: each caption's score against its own video."""
    V = sim_3d.shape[0]
    idx = torch.arange(V, device=sim_3d.device)[:, None, None].expand(
        V, sim_3d.shape[1], 1)
    return sim_3d.gather(2, idx)


def device_multi_sentence_ranks(sim_3d: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Text→video ranks for the caption-grouped [V, max_caps, V] tensor:
    (ranks [V, C], valid [V, C]); padded caption slots carry a -inf
    diagonal and are invalid."""
    own = _own_video(sim_3d)
    return (sim_3d > own).sum(dim=-1), torch.isfinite(own[..., 0])


def device_multi_sentence_ties(sim_3d: torch.Tensor) -> torch.Tensor:
    own = _own_video(sim_3d)
    tied = (sim_3d == own).sum(dim=-1) > 1
    return (tied & torch.isfinite(own[..., 0])).sum()


def device_video_to_text_ranks(sim_3d: torch.Tensor) -> torch.Tensor:
    """Video→text ranks: max over a video's captions, transposed, then the
    rank of the diagonal."""
    return device_ranks(sim_3d.amax(dim=1).T)


def device_video_to_text_ties(sim_3d: torch.Tensor) -> torch.Tensor:
    m = sim_3d.amax(dim=1).T
    diag = m.diagonal()
    return ((m == diag[:, None]).sum(dim=1) > 1).sum()


def log_tie_counts(logger, ties_t2v: int, ties_v2t: int) -> None:
    """One line, only when ties exist: on exactly these rows the strict
    device ranks differ from the reference's host compute_metrics."""
    ties_t2v, ties_v2t = int(ties_t2v), int(ties_v2t)
    if logger is not None and (ties_t2v or ties_v2t):
        logger.info(
            "Eval score ties at the diagonal: %d t2v row(s), %d v2t row(s) — "
            "strict ranks count one entry per query where the reference's "
            "host compute_metrics counts every tying column", ties_t2v,
            ties_v2t)


def metrics_from_ranks(ranks) -> Dict[str, float]:
    ranks = np.asarray(ranks)
    return {
        "R1": float(np.sum(ranks == 0)) * 100 / len(ranks),
        "R5": float(np.sum(ranks < 5)) * 100 / len(ranks),
        "R10": float(np.sum(ranks < 10)) * 100 / len(ranks),
        "R50": float(np.sum(ranks < 50)) * 100 / len(ranks),
        "MR": float(np.median(ranks)) + 1,
        "MedianR": float(np.median(ranks)) + 1,
        "MeanR": float(np.mean(ranks)) + 1,
    }


def compute_metrics(similarity) -> Dict[str, float]:
    """Rank-of-diagonal metrics of an [N, N] matrix (rows = queries), from
    strict ranks: one entry per query also where scores tie."""
    sim = torch.as_tensor(np.asarray(similarity))
    return metrics_from_ranks(device_ranks(sim).numpy())


class BestMetricsTracker:
    """Per-direction monotone-max R@1 tracking."""

    def __init__(self) -> None:
        self.best_mean_r1 = 1e-5
        self.best_t2v_r1 = 1e-5
        self.best_v2t_r1 = 1e-5
        self.best_t2v_metrics: Union[Dict[str, float], None] = None
        self.best_v2t_metrics: Union[Dict[str, float], None] = None

    def update(self, t2v: Dict[str, float], v2t: Dict[str, float]) -> bool:
        """True when the mean R@1 improved (the checkpoint trigger)."""
        improved = False
        mean_r1 = (t2v["R1"] + v2t["R1"]) / 2
        if mean_r1 > self.best_mean_r1:
            self.best_mean_r1 = mean_r1
            improved = True
        if t2v["R1"] > self.best_t2v_r1:
            self.best_t2v_r1 = t2v["R1"]
            self.best_t2v_metrics = dict(t2v)
        if v2t["R1"] > self.best_v2t_r1:
            self.best_v2t_r1 = v2t["R1"]
            self.best_v2t_metrics = dict(v2t)
        return improved

    # JSON round trip, so a resumed run cannot overwrite best.npz with
    # parameters worse than the best before the interruption
    def to_dict(self) -> Dict:
        return {"best_mean_r1": self.best_mean_r1,
                "best_t2v_r1": self.best_t2v_r1,
                "best_v2t_r1": self.best_v2t_r1,
                "best_t2v_metrics": self.best_t2v_metrics,
                "best_v2t_metrics": self.best_v2t_metrics}

    def load_dict(self, d: Dict) -> None:
        self.best_mean_r1 = d.get("best_mean_r1", self.best_mean_r1)
        self.best_t2v_r1 = d.get("best_t2v_r1", self.best_t2v_r1)
        self.best_v2t_r1 = d.get("best_v2t_r1", self.best_v2t_r1)
        self.best_t2v_metrics = d.get("best_t2v_metrics")
        self.best_v2t_metrics = d.get("best_v2t_metrics")


def format_metrics(metrics: Dict[str, float], prefix: str = "") -> str:
    return (f"{prefix}R@1: {metrics['R1']:.1f} - R@5: {metrics['R5']:.1f} - "
            f"R@10: {metrics['R10']:.1f} - R@50: {metrics.get('R50', 0.0):.1f} - "
            f"Median R: {metrics['MR']:.1f} - Mean R: {metrics['MeanR']:.1f}")
