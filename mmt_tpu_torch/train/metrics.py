"""Retrieval metrics: device ranks (ops/ranking.py) + a host reduction.

Port of mmt_tpu/train/metrics.py (cols2metrics, t2v_metrics, v2t_metrics,
device path, and fused_retrieval_metrics without its mesh branch):
tie-averaged ranks, query masking and the +1 offsets of MedR/MeanR as the
reference computes them.  The ranks are integers and halves, exact in
fp32.  From a matrix they reach the host as float64, so the reduction is
the numpy path's to the last bit; the fused path keeps them fp32, as the
JAX package's fused path does, so its MeanR is that path's.
"""

from __future__ import annotations

import numpy as np
import scipy.stats
import torch

from mmt_tpu_torch.ops import ranking


def cols2metrics(cols, num_queries):
  """R1/R5/R10/R50, MedR, MeanR and the R1-R5-R10 geometric mean (R1
  counts exact rank 0, so a two-way tie at the top does not count)."""
  cols = np.asarray(cols)
  metrics = {}
  metrics["R1"] = 100 * float(np.sum(cols == 0)) / num_queries
  metrics["R5"] = 100 * float(np.sum(cols < 5)) / num_queries
  metrics["R10"] = 100 * float(np.sum(cols < 10)) / num_queries
  metrics["R50"] = 100 * float(np.sum(cols < 50)) / num_queries
  metrics["MedR"] = float(np.median(cols) + 1)
  metrics["MeanR"] = float(np.mean(cols) + 1)
  stats = [metrics[x] for x in ("R1", "R5", "R10")]
  metrics["geometric_mean_R1-R5-R10"] = float(scipy.stats.mstats.gmean(stats))
  # A video whose captions are all masked has rank inf: keep it a float.
  metrics["cols"] = [int(i) if np.isfinite(i) else float(i)
                     for i in list(cols)]
  return metrics


def t2v_metrics(sims, query_masks=None):
  """Text-to-video metrics from a [Q, V] similarity tensor."""
  assert sims.dim() == 2, "expected a matrix"
  nq = sims.shape[0]
  cols = ranking.t2v_ranks(sims).cpu().double().numpy()
  if query_masks is not None:
    keep = np.asarray(query_masks).reshape(-1).astype(bool)
    assert keep.size == nq, "invalid query mask shape"
    cols = cols[keep]
    nq = int(keep.sum())
  return cols2metrics(cols, nq)


def v2t_metrics(sims, query_masks=None):
  """Video-to-text metrics (closest own caption) from [Q, V] sims."""
  assert sims.dim() == 2, "expected a matrix"
  nq, nv = sims.shape
  if query_masks is None:
    query_masks = np.ones((nv, nq // nv), np.float32)
  masks = torch.as_tensor(np.asarray(query_masks), device=sims.device)
  ranks = ranking.v2t_ranks(sims, masks).cpu().double().numpy()
  return cols2metrics(ranks, nv)


def fused_retrieval_metrics(text_embds, vid_embds, text_weights,
                            vid_weights, query_masks,
                            which=("t2v_metrics", "v2t_metrics"),
                            device="cuda"):
  """Retrieval metrics straight from embeddings, never building the
  [Q, V] similarity matrix (ops/ranking.py fused ranks): for corpora where
  the matrix would be GBs.  Semantics match t2v_metrics / v2t_metrics on
  the full matrix up to the rounding of near-ties.

  text_embds [Q, M, D], vid_embds [V, M, D], text_weights [Q, M],
  vid_weights [V, M] and query_masks [V, Q // V] (None: all valid), as
  numpy arrays or tensors; they are moved to ``device``.
  """
  to = lambda x: torch.as_tensor(x, device=device)
  te, ve, tw, vw = map(to, (text_embds, vid_embds, text_weights,
                            vid_weights))
  nv = ve.shape[0]
  if query_masks is None:
    query_masks = np.ones((nv, te.shape[0] // nv), np.float32)
  masks = torch.as_tensor(query_masks).cpu().numpy()
  out = {}
  if "t2v_metrics" in which:
    cols = ranking.fused_t2v_ranks(te, ve, tw, vw).cpu().numpy()
    keep = masks.reshape(-1).astype(bool)
    out["t2v_metrics"] = cols2metrics(cols[keep], int(keep.sum()))
  if "v2t_metrics" in which:
    ranks = ranking.fused_v2t_ranks(te, ve, tw, vw, to(masks)).cpu().numpy()
    out["v2t_metrics"] = cols2metrics(ranks[:nv], nv)
  return out
