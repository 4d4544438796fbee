"""Measured retrieval-quality delta of the int8-quantized serving index.

Port of scripts/int8_quality.py.  It isolates what quantization changes,
the scored similarity and the top-k, by feeding the same query
embeddings to the engine's two scoring routes:

* exact: ``serving.stage_index`` / ``index_similarity`` without
  quantization, the library product (two fp32 ``torch.mm``s), as the JAX
  script pins ``prefer_pallas=False`` and the JAX engine scores;
* int8: the same two functions with ``quantize="int8"``, the engine's
  int8 route (``torch._int_mm`` on the card).

The synthetic corpus has the flagship's geometry ([N, 7, 512]
L2-normalised per-modality embeddings, L1-normalised MoE weights) and a
planted ground truth: each query is a noise-perturbed copy of one
video's embedding, so R@K is a real retrieval metric.

  python -m mmt_tpu_torch.int8_quality            # 10k videos, 1k queries
  python -m mmt_tpu_torch.int8_quality --videos 512 --queries 64 \\
      --device cpu

Prints the JAX script's JSON report (``indent=2, sort_keys=True``), its
"backend" being the torch device type.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mmt_tpu_torch import serving


def make_corpus(num_videos, num_queries, modalities=7, dim=512, seed=0,
                noise=0.35, weight_noise=0.1):
  """scripts/int8_quality.py:make_corpus (the same numpy draws): [N, M, D]
  L2-normalised video embeddings, L1-normalised weights, and queries
  that are noisy copies of a ground-truth video's: (vid, vw, txt, tw,
  gt).  ``noise`` is the relative L2 perturbation between a query and
  its ground-truth video (0.35 puts the median GT rank at 1 with a
  realistic margin)."""
  rng = np.random.RandomState(seed)

  def l2norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

  def l1norm(w):
    return w / np.maximum(w.sum(-1, keepdims=True), 1e-12)

  vid = l2norm(rng.randn(num_videos, modalities, dim).astype(np.float32))
  vw = l1norm(np.abs(rng.randn(num_videos, modalities)).astype(np.float32))
  gt = rng.randint(0, num_videos, size=num_queries)
  txt = l2norm(vid[gt] + noise * rng.randn(num_queries, modalities, dim)
               .astype(np.float32))
  tw = l1norm(np.abs(vw[gt] + weight_noise
                     * rng.randn(num_queries, modalities)).astype(np.float32))
  return vid, vw, txt.astype(np.float32), tw.astype(np.float32), gt


def rank_both_paths(vid, vw, txt, tw, device, topk=10, batch=256):
  """(exact top-k ids, int8 top-k ids, exact top-k scores, the int8
  scores of the exact top-k's videos): the engine's two scoring routes
  over the same query embeddings, on ``device``.  The int8 scores are
  gathered at the exact top-k's ids, so each error is that of one video
  (a rank-by-rank difference would compare different videos wherever
  the rankings disagree)."""
  staged = {q: serving.stage_index(vid, vw, device, q) for q in (None, "int8")}
  idx_f, idx_q, sc_f, sc_q = [], [], [], []
  with torch.inference_mode():
    for s in range(0, len(txt), batch):
      t = torch.from_numpy(txt[s:s + batch]).to(device)
      w = torch.from_numpy(tw[s:s + batch]).to(device)
      exact = serving.index_similarity(t, w, staged[None], len(vid))
      q8 = serving.index_similarity(t, w, staged["int8"], len(vid), "int8")
      scores_f, top_f = torch.topk(exact, topk)
      idx_f.append(top_f.cpu().numpy())
      idx_q.append(torch.topk(q8, topk)[1].cpu().numpy())
      sc_f.append(scores_f.cpu().numpy())
      sc_q.append(torch.gather(q8, 1, top_f).cpu().numpy())
  return tuple(map(np.concatenate, (idx_f, idx_q, sc_f, sc_q)))


def quality_report(vid, vw, txt, tw, gt, device, topk=10, batch=256):
  """scripts/int8_quality.py:quality_report: R@1/5/10 of both routes,
  overlap@k, top-1 agreement, and the error of the int8 scores of each
  query's exact top-k videos."""
  idx_f, idx_q, sc_f, sc_q = rank_both_paths(vid, vw, txt, tw, device,
                                             topk=topk, batch=batch)
  rep = {}
  for k in (1, 5, 10):
    k = min(k, topk)
    rep[f"R{k}_fp32"] = float((idx_f[:, :k] == gt[:, None]).any(1).mean())
    rep[f"R{k}_int8"] = float((idx_q[:, :k] == gt[:, None]).any(1).mean())
    rep[f"overlap@{k}"] = float(np.mean([
        len(set(idx_f[q, :k]) & set(idx_q[q, :k])) / k
        for q in range(len(gt))]))
  rep["top1_identical"] = float((idx_f[:, 0] == idx_q[:, 0]).mean())
  rep["score_mae_topk"] = float(np.abs(sc_f - sc_q).mean())
  rep["score_max_err_topk"] = float(np.abs(sc_f - sc_q).max())
  return rep


def faults(rep):
  """The pinned rule of tests/test_serving.py's int8 quality test, as a
  list of what ``rep`` (``quality_report``'s) breaks: R@1/5/10
  identical, top-1 identical on >= 99% of queries, overlap@10 >= 0.95,
  top-k score MAE <= 1e-3."""
  found = [f"R{k}" for k in (1, 5, 10)
           if rep[f"R{k}_int8"] != rep[f"R{k}_fp32"]]
  if rep["top1_identical"] < 0.99:
    found.append("top1_identical")
  if rep["overlap@10"] < 0.95:
    found.append("overlap@10")
  if rep["score_mae_topk"] > 1e-3:
    found.append("score_mae_topk")
  return found


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--videos", type=int, default=10_000)
  p.add_argument("--queries", type=int, default=1_000)
  p.add_argument("--modalities", type=int, default=7)
  p.add_argument("--dim", type=int, default=512)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--noise", type=float, default=0.35)
  p.add_argument("--topk", type=int, default=10)
  p.add_argument("--device", default="cuda",
                 help="torch device (default: the card)")
  args = p.parse_args(argv)
  from mmt_tpu_torch.train.trainer import check_device
  device = check_device(args.device)

  vid, vw, txt, tw, gt = make_corpus(args.videos, args.queries,
                                     args.modalities, args.dim,
                                     seed=args.seed, noise=args.noise)
  rep = quality_report(vid, vw, txt, tw, gt, device, topk=args.topk)
  rep.update(videos=args.videos, queries=args.queries, seed=args.seed,
             noise=args.noise, backend=device.type)
  print(json.dumps(rep, indent=2, sort_keys=True))
  return rep


if __name__ == "__main__":
  main()
