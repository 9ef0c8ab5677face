"""Linear-sum assignment with padded rows, solved on the host (counterpart
of ``hungarian_cost_padded`` in ``memotr_tpu/ops/hungarian.py``).

The JAX package solves the assignment inside the compiled step with its own
Jonker-Volgenant loop.  The port does what the reference MeMOTR does
(``matcher.py``): it moves the cost matrices to the host and calls
``scipy.optimize.linear_sum_assignment`` (the same algorithm) on the valid
rows.  All problems of a call travel in one device-to-host copy, so a
caller that stacks the cost matrices of every decoder layer of a frame pays
one copy per frame; ``host_copies`` counts them.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

host_copies = 0


def _capped(cost: np.ndarray, row_mask: np.ndarray) -> np.ndarray:
    """Non-finite cells of one (R, C) problem -> a cost-scaled cap,
    ``fmax + (fmax - fmin + 1) * (R + 1)`` over the finite cells of valid
    rows, as the JAX version computes it: above any finite assignment's
    delta, yet close enough to the data for the solver's potentials."""
    r = cost.shape[0]
    valid = row_mask[:, None] & np.isfinite(cost)
    if not valid.all():
        fmax = cost[valid].max() if valid.any() else 0.0
        fmin = cost[valid].min() if valid.any() else 0.0
        cost = np.where(valid, cost,
                        np.float32(fmax + (fmax - fmin + 1.0) * (r + 1)))
    return cost


def hungarian_cost_padded(cost: torch.Tensor,
                          row_mask: torch.Tensor) -> torch.Tensor:
    """cost (..., R, C) with R <= C, row_mask (..., R) bool -> col4row
    (..., R) int64 on the cost's device: each valid row's assigned column,
    -1 for invalid rows.  No gradient flows through the assignment."""
    global host_copies
    lead, (r, c) = cost.shape[:-2], cost.shape[-2:]
    assert r <= c, "hungarian expects rows <= cols; transpose the cost"
    packed = torch.cat([cost.detach().float(),
                        row_mask[..., None].float()], dim=-1)
    packed = packed.reshape(-1, r, c + 1).cpu().numpy()        # one copy
    host_copies += 1
    out = np.full(packed.shape[:2], -1, np.int64)
    for i, prob in enumerate(packed):
        rows = prob[:, c] > 0.5
        if not rows.any():
            continue
        sub = _capped(prob[:, :c], rows)[rows]
        row_ind, col_ind = linear_sum_assignment(sub)
        out[i, np.nonzero(rows)[0][row_ind]] = col_ind
    return torch.from_numpy(out.reshape(*lead, r)).to(cost.device)
