"""Training losses on a similarity matrix.

Port of mmt_tpu/train/losses.py (the reference's model/loss.py:29-81):
masked reductions over the whole [n, n] matrix, positives on the
diagonal, computed in fp32.
"""

from __future__ import annotations

import torch


def max_margin_ranking_loss(margin: float = 1.0, fix_norm: bool = True):
  """Bidirectional max-margin ranking loss: relu(margin - x_ii + x_ij)
  over row negatives and relu(margin - x_ii + x_ji) over column
  negatives, averaged with one shared denominator; ``fix_norm`` leaves
  the diagonal terms out of the mean."""
  def loss_fn(x):
    x = x.float()
    n = x.shape[0]
    diag = x.diagonal()[:, None]
    row_terms = torch.relu(margin - (diag - x))
    col_terms = torch.relu(margin - (diag - x.T))
    if fix_norm:
      off = 1.0 - torch.eye(n, dtype=torch.float32, device=x.device)
      return ((row_terms * off).sum() + (col_terms * off).sum()) / (
          2.0 * n * (n - 1))
    return (row_terms.sum() + col_terms.sum()) / (2.0 * n * n)
  return loss_fn


def info_nce_loss():
  """Symmetric cross-entropy over rows and columns, diagonal labels."""
  def loss_fn(x):
    x = x.float()
    ce_rows = -torch.log_softmax(x, -1).diagonal().mean()
    ce_cols = -torch.log_softmax(x.T, -1).diagonal().mean()
    return ce_rows + ce_cols
  return loss_fn
