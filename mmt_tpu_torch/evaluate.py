"""Retrieval eval: embed a corpus in chunks, rank on the device and
reduce to metrics, from the [Q, V] MoE similarity matrix or (fused)
straight from the embeddings.

Port of mmt_tpu/train/trainer.py:_get_embeddings / _valid_epoch: the
matrix branch, which bench.py:build_full_eval times at 1k x 1k, and the
``use_fused`` branch, which never builds the matrix (bench.py's
streaming eval).
"""

from __future__ import annotations

import torch

from mmt_tpu_torch.ops import similarity as similarity_ops
from mmt_tpu_torch.train import metrics as metrics_lib
from mmt_tpu_torch.utils.timing import span


def embed_corpus(model, batches):
  """Run the model over each batch (a chunk of the corpus) under
  ``torch.inference_mode()`` and concatenate: text_embds [Q, M, D],
  text_weights [Q, M], vid_embds [V, M, D], vid_weights [V, M] and
  query_masks [V, K] (Q = V * K)."""
  parts = {k: [] for k in ("text_embds", "text_weights", "vid_embds",
                           "vid_weights", "query_masks")}
  with torch.inference_mode():
    for batch in batches:
      with span("mmt.eval.embed"):
        out = model(batch)
        b, k, m, d = out["text_embds"].shape
        parts["text_embds"].append(out["text_embds"].reshape(b * k, m, d))
        parts["text_weights"].append(out["text_weights"].reshape(b * k, m))
        parts["vid_embds"].append(out["vid_embds"])
        parts["vid_weights"].append(out["vid_weights"])
        parts["query_masks"].append(batch["query_masks"])
  return {k: torch.cat(v, 0) for k, v in parts.items()}


def retrieval_eval(model, batches, fused=False):
  """Embeddings -> sims (merge='indep') -> t2v / v2t metrics.

  Returns {"sims": [Q, V] tensor, "t2v_metrics": ..., "v2t_metrics": ...}.
  ``fused=True`` ranks straight from the embeddings
  (``metrics.fused_retrieval_metrics``): no sims matrix is built and the
  result has no "sims".  Spans ``mmt.eval`` and, in it, a
  ``mmt.eval.embed`` a chunk, ``mmt.eval.similarity`` (none when fused)
  and ``mmt.eval.ranks``.
  """
  with span("mmt.eval"):
    emb = embed_corpus(model, batches)
    if fused:
      with torch.inference_mode(), span("mmt.eval.ranks"):
        return metrics_lib.fused_retrieval_metrics(
            emb["text_embds"], emb["vid_embds"], emb["text_weights"],
            emb["vid_weights"], emb["query_masks"],
            device=emb["vid_embds"].device)
    num_caps = emb["query_masks"].shape[1]
    with torch.inference_mode():
      with span("mmt.eval.similarity"):
        sims = similarity_ops.moe_similarity(
            emb["text_embds"], emb["vid_embds"], emb["text_weights"],
            emb["vid_weights"], merge="indep", num_caps=num_caps)
      with span("mmt.eval.ranks"):
        masks = emb["query_masks"].cpu().numpy()
        return {"sims": sims,
                "t2v_metrics": metrics_lib.t2v_metrics(sims, masks),
                "v2t_metrics": metrics_lib.v2t_metrics(sims, masks)}
