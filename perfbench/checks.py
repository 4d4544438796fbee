"""The numbers that decide ``correct``: what the timed path produced,
held against the plain reference, each number against its limit.

Train cells (``train_numbers``), over the first steps of the very step
object the window then drives:

- ``loss_gap``: the widest relative gap of a step's loss;
- ``grad_gap``: of every leaf, the gap between the norm of the first
  step's gradient as the optimizer got it (Adam's first moment after one
  step over 1 - beta1) and the reference's norm, over the larger of the
  reference's norm of that leaf and of the median leaf; the widest;
- ``update_gap``: the same of the norm of each leaf's change over the
  checked steps, leaving out the leaves whose reference gradient is under
  a thousandth of the median leaf's (a key's bias under softmax moves by
  round-off alone);
- ``output_gap``: the widest absolute gap of the first step's tower
  outputs (unit-norm embeddings and MoE weights).

Eval cells (``eval_numbers``), over the last retrieval eval the window
completed:

- ``embedding_gap``: the widest absolute gap of both towers' outputs;
- ``sims_gap``: the widest absolute gap of the [Q, V] similarity;
- ``rank_mismatch``: the ranks, both directions, that differ from the
  reference's ranks of the program's own similarity (exact: limit 0);
- ``metric_gap``: the widest gap of R@1/5/10/50, MedR and MeanR from the
  reference's of those ranks (exact: limit 0).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from perfbench.reference import retrieval as ref_retrieval

# Leaves whose reference gradient is below this share of the median
# leaf's are left out of update_gap.
NEGLIGIBLE_GRAD = 1e-3


def _leaf_gap(prog, ref, names):
  floor = statistics.median(ref[n] for n in names)
  return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], floor)
             for n in names)


def max_abs_gap(prog, ref):
  """Widest |a - b| over the reference's tensors; inf where the
  program's has another shape."""
  return max(float((prog[k].float() - ref[k].float()).abs().max())
             if prog[k].shape == ref[k].shape else float("inf")
             for k in ref)


def train_numbers(prog, ref):
  """``prog``: {"losses", "grad_norms", "change_norms", "outputs"} of the
  program (a leaf it left without a gradient reads 0); ``ref``: the
  reference's (``reference.train.train_steps``)."""
  names = sorted(ref["grad_norms"])
  median = statistics.median(ref["grad_norms"][n] for n in names)
  moved = [n for n in names
           if ref["grad_norms"][n] >= NEGLIGIBLE_GRAD * median]
  return {
      "loss_gap": max(abs(a - b) / abs(b)
                      for a, b in zip(prog["losses"], ref["losses"])),
      "grad_gap": _leaf_gap(prog["grad_norms"], ref["grad_norms"], names),
      "update_gap": _leaf_gap(prog["change_norms"], ref["change_norms"],
                              moved),
      "output_gap": max_abs_gap(prog["outputs"], ref["outputs"]),
  }


def eval_numbers(prog, ref):
  """``prog``: {"outputs": concatenated tower outputs, "sims": [Q, V],
  "t2v_metrics", "v2t_metrics"} of the program; ``ref``: {"outputs",
  "sims"} of the reference."""
  sims = prog["sims"].float().cpu().numpy()
  mismatch, metric_gap = 0, 0.0
  for key, ranks in (("t2v_metrics", ref_retrieval.t2v_ranks(sims)),
                     ("v2t_metrics", ref_retrieval.v2t_ranks(sims))):
    got = prog[key]
    cols = np.asarray(got["cols"], np.float64)
    if cols.shape != ranks.shape:
      raise ValueError(f"{key}: {cols.shape} ranks against {ranks.shape}")
    mismatch += int(np.sum(cols != np.trunc(ranks)))  # cols are whole
    want = ref_retrieval.metrics(ranks)
    metric_gap = max([metric_gap] + [abs(got[m] - want[m])
                                     for m in ref_retrieval.METRICS])
  return {
      "embedding_gap": max_abs_gap(prog["outputs"], ref["outputs"]),
      "sims_gap": float((prog["sims"].float() - ref["sims"].float())
                        .abs().max()),
      "rank_mismatch": float(mismatch),
      "metric_gap": float(metric_gap),
  }


def judge(numbers, limits):
  """(the numbers outside their limits, {name: {"value", "limit"}}): a
  number without a limit, or not finite, is outside."""
  outside = [n for n, v in numbers.items()
             if limits.get(n) is None or not np.isfinite(v) or v > limits[n]]
  table = {n: {"value": float(v) if np.isfinite(v) else repr(v),
               "limit": limits.get(n)} for n, v in numbers.items()}
  return outside, table


def to_host(outputs):
  return {k: v.detach().float().cpu() for k, v in outputs.items()}


def leaf_norms(named):
  return {n: float(torch.linalg.vector_norm(t.float())) for n, t in named}
