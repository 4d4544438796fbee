"""Fused MoE-weighted cross-view similarity.

Port of mmt_tpu/ops/similarity.py:moe_similarity.  For every caption q
and video v:

    numer[q, v] = sum_m <tw[q, m] text[q, m, :], vw[v, m] vid[v, m, :]>
    denom[q, v] = sum_m tw[q, m] vw[v, m]          (0 -> 1e-5)
    sims[q, v]  = numer / denom

The weight pre-scaling and the flattening to [., M * D] happen here, in
torch, as in the JAX wrapper; the product, the denominator, the guard and
the divide are one CUDA kernel on the card (csrc/moe_similarity.cu), in
fp32 throughout, in a block-tile shape that ``pick_tile`` chooses per call
(every shape gives the same bits).  ``sim_plain`` is its plain PyTorch
version.  Under autograd ``MoESimilarity`` wraps the kernel contract (t,
v, tw, vw): the kernel (or plain version) forward, and the closed-form
backward of mmt_tpu/ops/similarity.py:_fused_bwd in plain torch (it was
einsums, not Pallas, on the TPU).  The pre-scaling stays outside, under
autograd.
"""

from __future__ import annotations

import torch

from mmt_tpu_torch import _build, ops

EPS_ZERO_GUARD = 1e-5


def sim_plain(t, v, tw, vw):
  """Plain version: t [Q, K], v [V, K] pre-scaled rows, tw [Q, M],
  vw [V, M] -> fp32 [Q, V]."""
  numer = t @ v.T
  denom = tw @ vw.T
  denom = torch.where(denom == 0, torch.full_like(denom, EPS_ZERO_GUARD),
                      denom)
  return numer / denom


# Block tiles (rows, columns) the similarity and rank kernels are built
# for; a tile's id is its index here and in the C entry points.  Both run
# 128 threads: 8 x 8 of the 128 x 64 tile per thread, 8 x 4 of the 64 x 64.
TILES = ((128, 64), (64, 64))
# Blocks of the 128 x 64 tile per SM from which it is the faster one.
FULL_CARD = 20


def pick_tile(q: int, v: int, sms: int) -> int:
  """Id of the tile for a [q, v] matrix on a card with ``sms`` SMs.

  The 128 x 64 tile does the fewest shared loads per FMA and wins once
  the card is full of blocks either way: by 1-8% for the similarity from
  5,000 x 5,000 to 14,000 x 14,000 (24 and 183 of its blocks per SM), by
  22% for the ranks at 20,000 x 20,000.  Below that a warp's own latency
  counts (each thread walks all of K, whatever the grid), and the 64 x 64
  tile's four times as many warps of half the work each hide more of it:
  3-30% faster up to 4,000 x 4,000 (15 blocks per SM), 44% at 32 x 32.
  Measured on an H100; the threshold lies between.
  """
  rows, cols = TILES[0]
  blocks = -(-q // rows) * -(-v // cols)
  return 0 if blocks >= FULL_CARD * sms else 1


def k_major_scratch(x):
  """Uninitialised [K, N rounded up to a multiple of 4] for the k-major
  copy of the [N, K] operand x, which the kernels' entry points fill and
  read: a tile's k rows are then contiguous, 16-byte-aligned runs."""
  n, k = x.shape
  return x.new_empty((k, -(-n // 4) * 4))


def _require(cond, msg):
  if not cond:
    raise ValueError(f"moe_similarity kernel: {msg}")


def sim_cuda(t, v, tw, vw, tile=None):
  """Launch csrc/moe_similarity.cu; same contract as ``sim_plain``.
  ``tile`` (an id of ``TILES``) overrides ``pick_tile``: for checks."""
  args = (t, v, tw, vw)
  _require(all(a.is_cuda and a.device == t.device for a in args),
           "every operand must lie on the same CUDA device")
  _require(all(a.dtype == torch.float32 for a in args),
           "operands must be float32")
  _require(all(a.dim() == 2 for a in args), "operands must be 2-D")
  q, k = t.shape
  nv, m = vw.shape
  _require(v.shape == (nv, k) and tw.shape == (q, m),
           f"shapes must be t [Q, K], v [V, K], tw [Q, M], vw [V, M]; got "
           f"{[tuple(a.shape) for a in args]}")
  _require(0 < m <= 32, f"needs 0 < M <= 32, got {m}")
  _require(all(a.is_contiguous() for a in args), "operands must be contiguous")
  out = torch.empty((q, nv), dtype=torch.float32, device=t.device)
  if tile is None:
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    tile = pick_tile(q, nv, sms)
  lib = _build.load_library()
  with torch.cuda.device(t.device):
    tt, vt = k_major_scratch(t), k_major_scratch(v)
    code = lib.mmt_moe_similarity(
        t.data_ptr(), v.data_ptr(), tw.data_ptr(), vw.data_ptr(),
        out.data_ptr(), tt.data_ptr(), vt.data_ptr(), q, nv, k, m,
        tt.shape[1], vt.shape[1], tile,
        torch.cuda.current_stream(t.device).cuda_stream)
  _build.check(lib, "mmt_moe_similarity", code)
  sim_cuda.launches += 1
  return out


sim_cuda.launches = 0


class MoESimilarity(torch.autograd.Function):
  """sims = (t v^T) / guard(tw vw^T) on pre-scaled t [Q, K], v [V, K].

  With gd = g / denom (the guarded denominator), the gradients are
  dt = gd v, dv = gd^T t, dtw = -(gd * sims) vw and dvw = -(gd * sims)^T
  tw.  The guard (denom == 0 -> 1e-5) is a constant: no gradient reaches
  tw or vw through a guarded entry.
  """

  @staticmethod
  def forward(ctx, t, v, tw, vw):
    fn = sim_cuda if ops.use_kernel(t) else sim_plain
    sims = fn(t, v, tw, vw)
    ctx.save_for_backward(t, v, tw, vw, sims)
    return sims

  @staticmethod
  def backward(ctx, g):
    t, v, tw, vw, sims = ctx.saved_tensors
    g = g.float()
    denom = tw @ vw.T
    guarded = denom == 0
    gd = g / torch.where(guarded, torch.full_like(denom, EPS_ZERO_GUARD),
                         denom)
    gs = torch.where(guarded, torch.zeros_like(gd), gd * sims)
    return gd @ v, gd.T @ t, -(gs @ vw), -(gs.T @ tw)


def moe_similarity(text_embds, vid_embds, text_weights, vid_weights,
                   merge: str = "avg", num_caps: int = 1):
  """Similarity matrix between all captions and all videos.

  text_embds [Q, M, D], vid_embds [V, M, D], text_weights [Q, M],
  vid_weights [V, M].  Returns fp32 [Q // num_caps, V] for 'avg' (mean
  over each video's captions) or [Q, V] for 'indep'.
  """
  if merge not in ("avg", "indep"):
    raise ValueError(f"unrecognised merge mode: {merge}")
  q, m, d = text_embds.shape
  nv = vid_embds.shape[0]
  tw = text_weights.float().contiguous()
  vw = vid_weights.float().contiguous()
  t = (text_embds.float() * tw[:, :, None]).reshape(q, m * d)
  v = (vid_embds.float() * vw[:, :, None]).reshape(nv, m * d)
  sims = MoESimilarity.apply(t, v, tw, vw)
  if num_caps > 1 and merge == "avg":
    sims = sims.reshape(q // num_caps, num_caps, nv).mean(1)
  return sims
