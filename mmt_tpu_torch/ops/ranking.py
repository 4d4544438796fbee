"""Tie-averaged retrieval ranks on the device.

Port of mmt_tpu/ops/ranking.py.  The rank of the ground truth is two
comparisons reduced over the candidate axis, no sort:

    rank(q) = #{v : d[q, v] < d_gt} + (#{v : d[q, v] == d_gt} - 1) / 2

``t2v_ranks`` / ``v2t_ranks`` rank a [Q, V] similarity matrix (plain
torch; they were never TPU kernels).  The fused path ranks straight from
the embeddings and never builds the matrix, for corpora where it would
be GBs: ``fused_counts`` gives each query's (closer, tied) counts against
all candidates, through the CUDA kernel csrc/fused_ranks.cu on the card
(the port of ``_rank_kernel``) or through ``fused_counts_plain``, which
walks the candidates in chunks so that at most [Q, 4096] of the matrix
exists at a time.  There the GT similarity is computed directly and the
GT column is excluded by index, so rank = closer + tied / 2.

``sharded_t2v_ranks`` / ``sharded_v2t_ranks`` are the data-parallel
version (mmt_tpu/ops/ranking.py:214 ``_cand_sharded``): queries
replicated, candidates split over the ranks.  Every rank holds the whole
embeddings on the host, stages the queries and its candidate shard on its
device, counts its shard with the GT column shifted into the shard's
coordinates (an index outside the shard never matches), and the integer
counts are all-reduced.  The GT similarities are taken from the whole
arrays in the unsharded call's arithmetic, so the ranks equal the
unsharded call's.
"""

from __future__ import annotations

import numpy as np
import torch

from mmt_tpu_torch import _build, ops
from mmt_tpu_torch.ops.similarity import k_major_scratch, pick_tile
from mmt_tpu_torch.utils.timing import span

MISSING_VAL = 1e8
EPS_ZERO_GUARD = 1e-5
CHUNK = 4096


def t2v_ranks(sims):
  """Rank of each caption's GT video (q // caps_per_video); fp32 [Q]."""
  with span("mmt.ranks"):
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
  with span("mmt.ranks"):
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


def _guard(denom):
  return torch.where(denom == 0, torch.full_like(denom, EPS_ZERO_GUARD),
                     denom)


def fused_counts_plain(queries, cands, qw, cw, gt, gtcol, colbias):
  """Plain version of the fused counts (the JAX package's
  ``_chunked_counts``).

  queries [Q, K] / cands [C, K]: weight-scaled fp32 rows; qw [Q, M] /
  cw [C, M]: their weights; gt [Q]: each query's GT similarity; gtcol [Q]:
  the candidate excluded per query (-1: none); colbias [C]: added to every
  similarity of a candidate (-MISSING_VAL marks a dead one).  Returns
  fp32 (closer [Q], tied [Q]).
  """
  nq = queries.shape[0]
  closer = torch.zeros(nq, device=queries.device)
  tied = torch.zeros(nq, device=queries.device)
  for s in range(0, cands.shape[0], CHUNK):
    c, w = cands[s:s + CHUNK], cw[s:s + CHUNK]
    sims = (queries @ c.T) / _guard(qw @ w.T) + colbias[s:s + CHUNK][None, :]
    col = s + torch.arange(c.shape[0], device=queries.device)
    valid = col[None, :] != gtcol[:, None]
    closer += (valid & (sims > gt[:, None])).sum(1).float()
    tied += (valid & (sims == gt[:, None])).sum(1).float()
  return closer, tied


def _require(cond, msg):
  if not cond:
    raise ValueError(f"fused_ranks kernel: {msg}")


def fused_counts_cuda(queries, cands, qw, cw, gt, gtcol, colbias, tile=None):
  """Launch csrc/fused_ranks.cu; same contract as ``fused_counts_plain``
  (gtcol of any integer type, passed to the kernel as int32).  While it
  runs, a second copy of queries and cands (k-major) is held.  ``tile`` (an
  id of ``similarity.TILES``) overrides ``pick_tile``: for checks."""
  _require(not gtcol.is_floating_point() and not gtcol.is_complex(),
           "gtcol must be an integer tensor")
  gtcol = gtcol.to(torch.int32)
  args = (queries, cands, qw, cw, gt, gtcol, colbias)
  _require(all(a.is_cuda and a.device == queries.device for a in args),
           "every operand must lie on the same CUDA device")
  _require(all(a.dtype == torch.float32 for a in args if a is not gtcol),
           "queries, cands, qw, cw, gt and colbias must be float32")
  nq, k = queries.shape
  nc, m = cw.shape
  _require(cands.shape == (nc, k) and qw.shape == (nq, m)
           and gt.shape == (nq,) and gtcol.shape == (nq,)
           and colbias.shape == (nc,),
           f"shapes must be queries [Q, K], cands [C, K], qw [Q, M], "
           f"cw [C, M], gt [Q], gtcol [Q], colbias [C]; got "
           f"{[tuple(a.shape) for a in args]}")
  _require(0 < m <= 32, f"needs 0 < M <= 32, got {m}")
  _require(all(a.is_contiguous() for a in args), "operands must be contiguous")
  closer = torch.zeros(nq, dtype=torch.int32, device=queries.device)
  tied = torch.zeros(nq, dtype=torch.int32, device=queries.device)
  if tile is None:
    props = torch.cuda.get_device_properties(queries.device)
    tile = pick_tile(nq, nc, props.multi_processor_count)
  lib = _build.load_library()
  with torch.cuda.device(queries.device):
    qt, ct = k_major_scratch(queries), k_major_scratch(cands)
    code = lib.mmt_fused_ranks(
        *(a.data_ptr() for a in args), closer.data_ptr(), tied.data_ptr(),
        qt.data_ptr(), ct.data_ptr(), nq, nc, k, m, qt.shape[1], ct.shape[1],
        tile,
        torch.cuda.current_stream(queries.device).cuda_stream)
  _build.check(lib, "mmt_fused_ranks", code)
  fused_counts_cuda.launches += 1
  return closer.float(), tied.float()


fused_counts_cuda.launches = 0


def fused_counts(queries, cands, qw, cw, gt, gtcol, colbias):
  """(closer, tied) counts: the kernel on the card, the plain version for
  CPU tensors (see ``fused_counts_plain`` for the arguments)."""
  fn = (fused_counts_cuda if ops.use_kernel(queries, "ranks")
        else fused_counts_plain)
  with span("mmt.ranks"):
    return fn(queries, cands, qw, cw, gt, gtcol, colbias)


def _scaled_flat(embds, weights):
  n, m, d = embds.shape
  w = weights.float().contiguous()
  return (embds.float() * w[:, :, None]).reshape(n, m * d), w


def _gt_from_rows(queries, gt_rows, qw, gt_w):
  """Direct GT similarity per query from its GT candidate's scaled rows
  and weights (O(N M D), no matrix)."""
  numer = (queries * gt_rows).sum(1)
  return numer / _guard((qw * gt_w).sum(1))


def _gt_sims(queries, cands, qw, cw, gtcol):
  """Direct GT similarity per query (O(N M D), no matrix)."""
  return _gt_from_rows(queries, cands[gtcol], qw, cw[gtcol])


def _t2v_ranks_from_counts(count_fn, text_embds, vid_embds, text_weights,
                           vid_weights, vid_valid=None):
  q, v = text_embds.shape[0], vid_embds.shape[0]
  t, tw = _scaled_flat(text_embds, text_weights)
  vv, vw = _scaled_flat(vid_embds, vid_weights)
  gt_col = torch.arange(q, device=t.device) // (q // v)
  gt = _gt_sims(t, vv, tw, vw, gt_col)
  colbias = torch.zeros(v, device=t.device)
  if vid_valid is not None:
    colbias = torch.where(vid_valid.to(t.device).bool(), colbias,
                          colbias - MISSING_VAL)
  closer, tied = count_fn(t, vv, tw, vw, gt, gt_col, colbias)
  # The GT column is excluded by index, so its self-tie's (1 - 1) / 2 = 0
  # is already accounted for.
  return closer + tied / 2.0


def fused_t2v_ranks(text_embds, vid_embds, text_weights, vid_weights,
                    vid_valid=None):
  """Tie-averaged t2v GT ranks straight from embeddings (no sims matrix).

  text_embds [Q, M, D], vid_embds [V, M, D], text_weights [Q, M],
  vid_weights [V, M], Q = V * caps.  ``vid_valid`` (optional [V]): dead
  candidates (padding rows) are biased by -MISSING_VAL, so they never
  outrank a live video.  Returns fp32 [Q], equal to
  ``t2v_ranks(moe_similarity(..., merge='indep'))`` up to the rounding of
  near-ties (the GT value is computed directly).
  """
  return _t2v_ranks_from_counts(fused_counts, text_embds, vid_embds,
                                text_weights, vid_weights, vid_valid)


def _v2t_ranks_from_counts(count_fn, text_embds, vid_embds, text_weights,
                           vid_weights, query_masks):
  q, v = text_embds.shape[0], vid_embds.shape[0]
  cpv = q // v
  t_cand, tw = _scaled_flat(text_embds, text_weights)
  v_query, vw = _scaled_flat(vid_embds, vid_weights)
  mask_flat = query_masks.reshape(-1).to(t_cand.device).bool()
  colbias = torch.where(mask_flat, 0.0, -MISSING_VAL)   # dead caption slots
  best = torch.full((v,), float("inf"), device=t_cand.device)
  for j in range(cpv):   # one counts call per caption slot
    gt_col = torch.arange(v, device=t_cand.device) * cpv + j
    gt = _gt_sims(v_query, t_cand, vw, tw, gt_col)
    closer, tied = count_fn(v_query, t_cand, vw, tw, gt, gt_col, colbias)
    rank_j = torch.where(mask_flat[gt_col], closer + tied / 2.0,
                         float("inf"))
    best = torch.minimum(best, rank_j)
  return best


def fused_v2t_ranks(text_embds, vid_embds, text_weights, vid_weights,
                    query_masks):
  """Min tie-averaged rank of each video's own captions among all caption
  slots, straight from embeddings; fp32 [V].  Masked caption slots are
  biased by -MISSING_VAL, so they never outrank live ones; a video whose
  slots are all masked gets inf.  Equal to ``v2t_ranks(moe_similarity(...,
  merge='indep'), query_masks)`` up to the rounding of near-ties."""
  return _v2t_ranks_from_counts(fused_counts, text_embds, vid_embds,
                                text_weights, vid_weights, query_masks)


# The JAX package's backend dispatch (Pallas on a TPU, chunked XLA
# elsewhere) under its names; on the port ``fused_counts`` dispatches.
t2v_ranks_from_embeddings = fused_t2v_ranks
v2t_ranks_from_embeddings = fused_v2t_ranks


# ----------------------------------------------------------------------
# Candidate-sharded ranks (data parallelism)
# ----------------------------------------------------------------------
def _shard(n, dp):
  """[start, stop) of this rank's candidates, the count padded with dead
  candidates to divide the group."""
  per = -(-n // dp.size)
  return dp.rank * per, (dp.rank + 1) * per


def _stage_scaled(embds, weights, rows, device):
  """Host rows ``rows`` of (embds, weights) as scaled flat fp32 device
  rows (``_scaled_flat``); ``rows`` a slice past the end is zero-padded."""
  e, w = embds[rows], weights[rows]
  n = rows.stop - rows.start if isinstance(rows, slice) else len(rows)
  if len(e) < n:
    pad = n - len(e)
    e = np.concatenate([e, np.zeros((pad,) + e.shape[1:], e.dtype)])
    w = np.concatenate([w, np.zeros((pad,) + w.shape[1:], w.dtype)])
  to = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
  return _scaled_flat(to(e), to(w))


def _summed_counts(counts, dp):
  """The ranks' (closer, tied) counts [..., 2, Q] summed as integers;
  fp32 back."""
  total = counts.to(torch.int64)
  dp.reduce_(total)
  return total.float()


def sharded_t2v_ranks(text_embds, vid_embds, text_weights, vid_weights, dp,
                      device):
  """``fused_t2v_ranks`` with the videos split over ``dp``'s ranks: host
  (numpy) inputs of the whole corpus on every rank; this rank stages all
  captions and its videos on ``device`` and launches one count; returns
  the fp32 [Q] ranks of the whole corpus, the same on every rank and
  equal to ``fused_t2v_ranks`` on the same embeddings."""
  q, v = len(text_embds), len(vid_embds)
  t, tw = _stage_scaled(text_embds, text_weights, slice(0, q), device)
  gt_col = np.arange(q) // (q // v)
  g, gw = _stage_scaled(vid_embds, vid_weights, gt_col, device)
  gt = _gt_from_rows(t, g, tw, gw)
  del g, gw
  start, stop = _shard(v, dp)
  vv, vw = _stage_scaled(vid_embds, vid_weights, slice(start, stop), device)
  colbias = torch.zeros(stop - start, device=t.device)
  colbias[max(v - start, 0):] = -MISSING_VAL           # the pad videos
  local = torch.as_tensor(gt_col - start, device=t.device)
  closer, tied = fused_counts(t, vv, tw, vw, gt, local, colbias)
  closer, tied = _summed_counts(torch.stack([closer, tied]), dp)
  return closer + tied / 2.0


def sharded_v2t_ranks(text_embds, vid_embds, text_weights, vid_weights,
                      query_masks, dp, device):
  """``fused_v2t_ranks`` with the caption slots split over ``dp``'s ranks
  (host inputs of the whole corpus on every rank; the pad slots masked):
  one count per caption slot on this rank's slots; returns the fp32 [V]
  ranks, the same on every rank and equal to ``fused_v2t_ranks``."""
  q, v = len(text_embds), len(vid_embds)
  cpv = q // v
  vq, vw = _stage_scaled(vid_embds, vid_weights, slice(0, v), device)
  mask_flat = np.asarray(query_masks).reshape(-1).astype(bool)
  start, stop = _shard(v, dp)                       # in videos, then slots
  start, stop = start * cpv, stop * cpv
  tc, tcw = _stage_scaled(text_embds, text_weights, slice(start, stop),
                          device)
  live = np.zeros(stop - start, bool)
  live[:max(min(q, stop) - start, 0)] = mask_flat[start:stop]
  colbias = torch.where(torch.as_tensor(live, device=vq.device), 0.0,
                        -MISSING_VAL)
  counts = []
  for j in range(cpv):   # one counts call per caption slot
    gt_col = np.arange(v) * cpv + j
    g, gw = _stage_scaled(text_embds, text_weights, gt_col, device)
    gt = _gt_from_rows(vq, g, vw, gw)
    local = torch.as_tensor(gt_col - start, device=vq.device)
    counts.append(torch.stack(fused_counts(vq, tc, vw, tcw, gt, local,
                                           colbias)))
  counts = _summed_counts(torch.stack(counts), dp)
  best = torch.full((v,), float("inf"), device=vq.device)
  for j in range(cpv):
    own = torch.as_tensor(mask_flat[np.arange(v) * cpv + j],
                          device=vq.device)
    rank_j = torch.where(own, counts[j, 0] + counts[j, 1] / 2.0,
                         float("inf"))
    best = torch.minimum(best, rank_j)
  return best
