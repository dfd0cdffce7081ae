"""The numbers `correct` compares, from the program's readings and the
reference's.

Training: each check step's loss, the first step's gradient as the
optimizer takes it (after both clips) by leaf, each leaf's change over the
check steps, and the bank's text and video features after them (the
towers' output at every row the fill and the steps wrote, as a relative L2
distance, the worse of the two sides); and, where both sides give it, the
first step's bank centralities worked out from the program's own features
and bank (`centrality_gap`, in similarity units: the similarity family
alone).  A leaf's gap is |program's norm - reference's norm| over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient lies under a thousandth of the median
leaf's (nought but rounding, such as a key bias under softmax, or a net the
loss does not reach) move by round-off or weight decay alone and are left
out of the change.

Search: for each judged request and rank, the program's score against the
reference's score of the same video, and how far the reference puts the
program's video below its own video of that rank.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

KEEP_FRACTION = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               names: Sequence[str]) -> List[float]:
    med = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"loss": [per check step], "grad": {leaf: norm},
    "change": {leaf: norm}, "bank": (text, video features)} → the compared
    numbers, and beside them the
    median leaf's gaps and the worst leaves' names."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["loss"], ref["loss"]))
    names = sorted(ref["grad"])
    grad = _leaf_gaps(prog["grad"], ref["grad"], names)
    med_g = statistics.median(ref["grad"][n] for n in names)
    kept = [n for n in names if ref["grad"][n] >= KEEP_FRACTION * med_g]
    change = _leaf_gaps(prog["change"], ref["change"], kept)
    bank_gap = max(float((p.float() - r.float()).norm() / r.float().norm())
                   for p, r in zip(prog["bank"], ref["bank"]))
    nums = {"loss_gap": loss_gap, "bank_gap": bank_gap, "grad_gap": max(grad),
            "change_gap": max(change),
            "grad_gap_median_leaf": statistics.median(grad),
            "change_gap_median_leaf": statistics.median(change),
            "grad_gap_leaf": names[grad.index(max(grad))],
            "change_gap_leaf": kept[change.index(max(change))]}
    if "centrality" in ref:
        nums["centrality_gap"] = centrality_gap(prog.get("centrality", {}),
                                                ref["centrality"])
    return nums


def centrality_gap(prog: dict, ref: dict) -> float:
    """The largest |program's - reference's| bank centrality over both
    axes, in similarity units; inf when the program's were not observed
    or do not cover the batch's rows."""
    if set(prog) != set(ref) or any(prog[a].shape != ref[a].shape
                                    for a in ref):
        return math.inf
    return max(float((prog[a].double() - ref[a].double()).abs().max())
               for a in ref)


def search_numbers(prog_ids, prog_scores, ref_all_scores, ref_top_scores
                   ) -> Dict[str, float]:
    """prog_ids, prog_scores [R, k]: what the program returned; ref_all
    [R, N]: the reference's scores of every video; ref_top [R, k]: its own
    best k."""
    import torch
    ids = torch.as_tensor(prog_ids, dtype=torch.long,
                          device=ref_all_scores.device)
    got = torch.as_tensor(prog_scores, dtype=torch.float32,
                          device=ref_all_scores.device)
    ref_of_got = torch.gather(ref_all_scores, 1, ids)
    return {"score_gap": float((got - ref_of_got).abs().max()),
            "rank_gap": float((ref_top_scores - ref_of_got).clamp_min(0)
                              .max())}
