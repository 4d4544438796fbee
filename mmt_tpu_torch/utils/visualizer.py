"""Qualitative retrieval visualizer.

Parity with utils/visualizer.py:34-191: every ``vis_vid_freq`` epochs (and
at final eval) sample up to ``num_samples`` valid queries and emit an HTML
page showing each query's caption, its per-modality MoE weights, and the
top-5 ranked videos with the ground truth highlighted.

A copy of mmt_tpu/utils/visualizer.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import logging
import pathlib
from typing import Sequence

import numpy as np

from mmt_tpu_torch.registry import register
from mmt_tpu_torch.utils.html_report import HTMLReport

logger = logging.getLogger(__name__)


@register("visualizer", "Visualizer")
class Visualizer:
  def __init__(self, exp_name: str = "", web_dirs: Sequence = (),
               vis_vid_freq: float = 0, num_samples: int = 20):
    self.exp_name = exp_name
    self.web_dirs = [pathlib.Path(d) for d in web_dirs]
    self.vis_vid_freq = vis_vid_freq
    self.num_samples = num_samples

  def should_visualize(self, epoch, sets: str) -> bool:
    if sets == "final_eval":
      return True
    return bool(self.vis_vid_freq) and epoch is not None and (
        epoch % int(self.vis_vid_freq) == 0)

  def visualize_ranking(self, sims, query_masks, epoch, meta,
                        nested_metrics, modalities, subdir_name,
                        sets, tokenizer=None, topk: int = 5):
    if not self.should_visualize(epoch, sets) or not self.web_dirs:
      return
    nq, nv = sims.shape
    caps_per_vid = nq // nv
    valid = (np.asarray(query_masks).reshape(-1).astype(bool)
             if query_masks is not None else np.ones(nq, bool))
    valid_idx = np.nonzero(valid)[0]
    rng = np.random.RandomState(0)
    pick = rng.choice(valid_idx, size=min(self.num_samples, len(valid_idx)),
                      replace=False)

    paths = meta.get("paths", ["?"] * nv)
    raw_captions = meta.get("raw_captions")
    text_weights = np.asarray(meta.get("text_weights"))
    vid_weights = np.asarray(meta.get("vid_weights"))

    for web_dir in self.web_dirs:
      report = HTMLReport(web_dir / subdir_name,
                          f"{self.exp_name} epoch {epoch} {subdir_name}")
      for q in pick:
        vid_idx = q // caps_per_vid
        order = np.argsort(-sims[q])
        gt_rank = int(np.nonzero(order == vid_idx)[0][0])
        caption = "?"
        if raw_captions is not None:
          cap = raw_captions[vid_idx]
          cap = cap[q % caps_per_vid] if isinstance(cap, (list, tuple)) else cap
          caption = " ".join(str(w) for w in np.asarray(cap).reshape(-1))
        tw = (text_weights.reshape(nq, -1)[q]
              if text_weights.ndim else [])
        rows = []
        for rank, v in enumerate(order[:topk]):
          rows.append({"path": paths[v] if v < len(paths) else "?",
                       "rank": rank, "sim": float(sims[q, v]),
                       "is_gt": bool(v == vid_idx),
                       "vid_weights": (vid_weights[v]
                                       if vid_weights.ndim == 2 else [])})
        report.add_query(caption, tw, modalities, gt_rank,
                         float(sims[q, vid_idx]), rows)
      out = report.save(f"epoch{epoch}.html")
      logger.debug("wrote ranking page %s", out)
