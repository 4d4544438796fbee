"""Fused MoE-weighted cross-view similarity.

Port of mmt_tpu/ops/similarity.py:moe_similarity.  For every caption q
and video v:

    numer[q, v] = sum_m <tw[q, m] text[q, m, :], vw[v, m] vid[v, m, :]>
    denom[q, v] = sum_m tw[q, m] vw[v, m]          (0 -> 1e-5)
    sims[q, v]  = numer / denom

The weight pre-scaling and the flattening to [., M * D] happen here, in
torch, as in the JAX wrapper; the product, the denominator, the guard and
the divide are one CUDA kernel on the card (csrc/moe_similarity.cu), in
fp32 throughout.  ``sim_plain`` is its plain PyTorch version.  Under
autograd ``MoESimilarity`` wraps the kernel contract (t, v, tw, vw): the
kernel (or plain version) forward, and the closed-form backward of
mmt_tpu/ops/similarity.py:_fused_bwd in plain torch (it was einsums, not
Pallas, on the TPU).  The pre-scaling stays outside, under autograd.
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


def _require(cond, msg):
  if not cond:
    raise ValueError(f"moe_similarity kernel: {msg}")


def sim_cuda(t, v, tw, vw):
  """Launch csrc/moe_similarity.cu; same contract as ``sim_plain``."""
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
  lib = _build.load_library()
  with torch.cuda.device(t.device):
    code = lib.mmt_moe_similarity(
        t.data_ptr(), v.data_ptr(), tw.data_ptr(), vw.data_ptr(),
        out.data_ptr(), q, nv, k, m,
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
