"""Plain reference of the retrieval eval: both towers over the corpus in
chunks, the [Q, V] MoE similarity with each caption its own query, the
tie-averaged ranks in both directions and the retrieval metrics."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as ref_model

METRICS = ("R1", "R5", "R10", "R50", "MedR", "MeanR")


def embed(params, cfg, chunks):
  """Eval-mode outputs over ``chunks``, concatenated: text_embds [Q, M, D]
  (Q = V K), text_weights [Q, M], vid_embds [V, M, D], vid_weights [V, M]."""
  parts = []
  with torch.no_grad():
    for batch in chunks:
      out = ref_model.forward(params, cfg, batch)
      b, k, m, d = out["text_embds"].shape
      out["text_embds"] = out["text_embds"].reshape(b * k, m, d)
      out["text_weights"] = out["text_weights"].reshape(b * k, m)
      parts.append(out)
  return {key: torch.cat([o[key] for o in parts]) for key in parts[0]}


def sims(emb):
  with torch.no_grad():
    return ref_model.similarity(emb["text_embds"], emb["text_weights"],
                                emb["vid_embds"], emb["vid_weights"])


def _rank(row, gt):
  """Tie-averaged rank of value ``gt`` among ``row`` (0 = best)."""
  return float((row > gt).sum()) + (float((row == gt).sum()) - 1.0) / 2.0


def t2v_ranks(s):
  """Rank of each caption's own video (caption q of video q // K)."""
  s = np.asarray(s, np.float32)
  k = s.shape[0] // s.shape[1]
  return np.array([_rank(s[q], s[q, q // k]) for q in range(s.shape[0])])


def v2t_ranks(s):
  """Best rank among each video's own captions, over all captions."""
  s = np.asarray(s, np.float32)
  k = s.shape[0] // s.shape[1]
  return np.array([min(_rank(s[:, v], s[v * k + j, v]) for j in range(k))
                   for v in range(s.shape[1])])


def metrics(ranks):
  """R@1/5/10/50 in %, and the median and mean rank counted from 1."""
  ranks = np.asarray(ranks, np.float64)
  out = {f"R{n}": 100.0 * float(np.sum(ranks < n if n > 1 else ranks == 0))
         / len(ranks) for n in (1, 5, 10, 50)}
  out["MedR"] = float(np.median(ranks) + 1)
  out["MeanR"] = float(np.mean(ranks) + 1)
  return out
