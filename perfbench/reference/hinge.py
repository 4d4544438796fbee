"""Plain reference of the train step (``reference/train.py``) whose
max-margin loss takes the side of each hinge term's kink from the
program's own similarity of that step.

A term relu(margin - x_ii + x_ij) whose argument lies within rounding of
0 is counted by the program and not by the reference, or the other way
round, now and then: its gradient then differs by a whole term (1 /
(2 n (n - 1)) of the similarity's), which Adam carries into every leaf
of the following steps.  So, as ``reference/moe_text.py`` follows the
program's expert choices, the reference here counts a term where the
program counted it, and reports ``hinge_gap``: the largest |argument| of
the reference's own terms that lie on the other side of the kink from
the program's (0 where every side agrees, a rounding-sized number at a
near-tie).  Everything else stays continuous in the program's outputs.
"""

from __future__ import annotations

from unittest import mock

import torch

from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train


def _arguments(sims, margin):
  """Both directions' hinge arguments [2, n, n], in the program's order
  of operations (``train/losses.py``: margin - (x_ii - x_ij))."""
  diag = sims.diagonal()[:, None]
  return torch.stack([margin - (diag - sims), margin - (diag - sims.T)])


def following_loss(sims, program_sims, margin, fix_norm=True):
  """(``ref_model.max_margin_loss`` of ``sims`` with each term counted
  where the program's similarity ``program_sims`` counts it, hinge_gap)."""
  n = sims.shape[0]
  args = _arguments(sims, margin)
  counted = _arguments(program_sims.to(sims), margin) > 0
  pairs = torch.ones(n, n, device=sims.device)
  if fix_norm:
    pairs = pairs - torch.eye(n, device=sims.device)
  loss = (args * counted * pairs).sum() / (
      2.0 * n * (n - 1 if fix_norm else n))
  crossed = ((args > 0) != counted) & (pairs > 0)
  gap = float(args.detach().abs()[crossed].max()) if crossed.any() else 0.0
  return loss, gap


def train_steps(params0, cfg, batches, generator, program_sims=None):
  """``reference.train.train_steps``, plus "sims": each step's similarity
  (host), and where ``program_sims`` (one [n, n] a step) is given, each
  term's side taken from it and "hinge_gap", the widest over the steps."""
  seen, gaps = [], []
  plain = ref_model.max_margin_loss

  def loss(sims, margin, fix_norm=True):
    seen.append(sims.detach().cpu())
    if program_sims is None:
      return plain(sims, margin, fix_norm)
    value, gap = following_loss(sims, program_sims[len(seen) - 1], margin,
                                fix_norm)
    gaps.append(gap)
    return value

  with mock.patch.object(ref_model, "max_margin_loss", loss):
    out = ref_train.train_steps(params0, cfg, batches, generator)
  out["sims"] = seen
  if program_sims is not None:
    out["hinge_gap"] = max(gaps)
  return out

