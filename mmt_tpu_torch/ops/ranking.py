"""Tie-averaged retrieval ranks on the device, in plain PyTorch.

Port of mmt_tpu/ops/ranking.py:t2v_ranks / v2t_ranks.  The rank of the
ground truth is two comparisons reduced over the candidate axis, no sort:

    rank(q) = #{v : d[q, v] < d_gt} + (#{v : d[q, v] == d_gt} - 1) / 2

These were never TPU kernels; the at-scale fused ranking kernel
(``_rank_kernel``) is not on this slice.
"""

from __future__ import annotations

import torch

MISSING_VAL = 1e8


def t2v_ranks(sims):
  """Rank of each caption's GT video (q // caps_per_video); fp32 [Q]."""
  q, v = sims.shape
  d = -sims.float()
  gt_col = torch.arange(q, device=sims.device) // (q // v)
  d_gt = d.gather(1, gt_col[:, None])
  closer = (d < d_gt).sum(1).float()
  tied = (d == d_gt).sum(1).float()
  return closer + (tied - 1.0) / 2.0


def v2t_ranks(sims, query_masks):
  """Min rank over each video's own captions; fp32 [V].

  query_masks [V, caps_per_video]: masked caption slots get distance
  MISSING_VAL (they still occupy a slot) and are never ranked; a video
  with no valid caption gets rank inf.
  """
  q, v = sims.shape
  cpv = q // v
  mask = query_masks.reshape(-1).to(device=sims.device, dtype=torch.bool)
  d = -sims.float().T                                  # [V, Q]
  d = torch.where(mask[None, :], d, torch.full_like(d, MISSING_VAL))
  own = d.reshape(v, v, cpv)[torch.arange(v), torch.arange(v)]  # [V, cpv]
  own_valid = mask.reshape(v, cpv)
  best = torch.full((v,), float("inf"), device=sims.device)
  for j in range(cpv):
    dj = own[:, j:j + 1]
    closer = (d < dj).sum(1).float()
    tied = (d == dj).sum(1).float()
    rank_j = closer + (tied - 1.0) / 2.0
    rank_j = torch.where(own_valid[:, j], rank_j,
                         torch.full_like(rank_j, float("inf")))
    best = torch.minimum(best, rank_j)
  return best
