"""Log-space Sinkhorn optimal transport for the uniform-regularisation
targets (↔ neighborretr_tpu/ops/sinkhorn.py): uniform marginals
log_mu = log_nu = -log(m+n), `num_iterations` dual updates in log space,
plan Z = scores + u ⊕ v - log_mu.  The plan is a constant with respect to
the scores (no gradient), and the target is β·Q + (1-β)·I.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def sinkhorn_transport_plan(scores: torch.Tensor,
                            num_iterations: int = 50) -> torch.Tensor:
    scores = scores.detach().float()
    m, n = scores.shape
    norm = -math.log(float(m + n))
    u = scores.new_zeros(m)
    v = scores.new_zeros(n)
    for _ in range(num_iterations):
        u = norm - torch.logsumexp(scores + v[None, :], dim=1)
        v = norm - torch.logsumexp(scores + u[:, None], dim=0)
    return torch.exp(scores + u[:, None] + v[None, :] - norm)


def sinkhorn_targets(scores: torch.Tensor, beta: float,
                     num_iterations: int = 50) -> torch.Tensor:
    q = sinkhorn_transport_plan(scores, num_iterations)
    eye = torch.eye(scores.shape[0], scores.shape[1], device=scores.device)
    return beta * q + (1.0 - beta) * eye
